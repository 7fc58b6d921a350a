// Sparse SGD row update with the duplicate-id pre-reduce fused in, one warp
// per sorted id, writing the table in place.
//
// Replaces the TPU kernel src/repro/kernels/embedding_update.py::gather_fma_rows
// (body _gather_fma_kernel) together with the segment-sum that its wrapper
// src/repro/kernels/ops.py::sparse_row_update runs before it.  Inputs are the
// step's ids sorted by a stable sort (sids) and the sort's permutation
// (order).  The warp of sorted position i returns at once unless i heads a run
// of equal ids (the dead lanes); a head warp sums grads[order[j]] over its run
// in sorted order, which is the ids' original order, and writes
//     table[sids[i]] = table[sids[i]] - lr * sum
// with the multiply and the subtract rounded separately, as the plain version
// computes it.  After the pre-reduce every written row is unique, so no atomics
// are needed and repeated runs give the same bits.
//
// Bound on an H100 (3.35 TB/s): bytes.  At B=1,024 and a 1,024-row tile the
// step touches 2,048 rows: reading the grads and ids and reading and writing
// each unique table row once is about 3 MB, about 1 us.  At that size the
// launch itself (a few us) dominates, so the design keeps the whole update in
// one launch per step; each lane handles K/32 columns of its row, so the
// accesses of one warp are contiguous.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_fma_kernel(float* __restrict__ table, const int64_t* __restrict__ sids,
                                  const int64_t* __restrict__ order,
                                  const float* __restrict__ grads, int B, int K, float lr) {
  const int i = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= B) return;
  const int64_t id = sids[i];
  if (i > 0 && sids[i - 1] == id) return;  // not the head of its run
  int end = i + 1;
  while (end < B && sids[end] == id) ++end;
  float* row = table + id * (int64_t)K;
  for (int k = lane; k < K; k += 32) {
    float acc = 0.f;
    for (int j = i; j < end; ++j) acc = __fadd_rn(acc, grads[order[j] * (int64_t)K + k]);
    row[k] = __fsub_rn(row[k], __fmul_rn(lr, acc));
  }
}

}  // namespace

extern "C" int gather_fma_rows(void* table, const void* sids, const void* order,
                               const void* grads, int B, int K, float lr, void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;  // 8 warps, 8 sorted ids per block
  const int blocks = (B + 7) / 8;
  gather_fma_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (float*)table, (const int64_t*)sids, (const int64_t*)order, (const float*)grads, B, K,
      lr);
  return (int)cudaGetLastError();
}

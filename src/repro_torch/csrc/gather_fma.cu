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
//     table[sids[i]] = table[sids[i]] - lr * (0 + g_0 + g_1 + ...)
// with every add, the multiply and the subtract rounded separately (no FMA
// contraction), as the plain version computes it.  After the pre-reduce
// every written row is unique, so no atomics are needed and repeated runs
// give the same bits.
//
// Bound on an H100 (3.35 TB/s): bytes.  At B=1,024 and a 1,024-row tile the
// step touches 2,048 ids: reading the grads and ids and reading and writing
// each unique table row once is about 2.7 MB, under 1 us.  What a call
// really waits for is the chain of dependent device-memory round trips
// (about 0.5-1 us each with a cold L2) behind the launch, so the design
// keeps the chain short:
//   1. one round trip: every lane loads sids[i-1] (the head test), sids[i +
//      lane] and order[i + lane], coalesced and all at once; non-head warps
//      return here.  The run's end is the first lane whose id differs
//      (__ballot_sync; a loop takes runs longer than 32), and the run's
//      order[] entries are already in the lanes, broadcast with __shfl_sync.
//   2. one round trip: each lane owns 4 consecutive columns (a float4 where
//      K % 4 == 0 and the rows are 16-byte aligned, one column otherwise) of
//      32-lane strides of the row, and loads the table row together with the
//      first 8 of the run's gradient rows, written out straight-line from
//      the order[] values of step 1, before summing them in order.  (Inside
//      a loop the compiler re-loaded order[] from memory rather than keep
//      step 1's values in registers: one more round trip.)
//      Longer runs take 8 more rows per round trip.
//   3. the store.
// The launch itself is most of a call at this size: a one-element kernel
// takes about 5 us in chip_smoke.py's timing (tools/probe_kernels.py).
// Row offsets are 64-bit, so tables past 2^31 bytes are addressed right.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;        // sorted ids per block
constexpr int UNROLL = 8;       // gradient rows in flight per lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float zero(float) { return 0.f; }
__device__ __forceinline__ float4 zero(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// t - lr * s, the multiply and the subtract rounded separately.
__device__ __forceinline__ float step(float t, float lr, float s) {
  return __fsub_rn(t, __fmul_rn(lr, s));
}
__device__ __forceinline__ float4 step(float4 t, float lr, float4 s) {
  return make_float4(step(t.x, lr, s.x), step(t.y, lr, s.y), step(t.z, lr, s.z),
                     step(t.w, lr, s.w));
}

// V is float4 (K % 4 == 0, 16-byte aligned rows) or float; a row holds
// `width` elements of V.
template <typename V>
__global__ void __launch_bounds__(32 * WARPS)
gather_fma_kernel(float* __restrict__ table, const int64_t* __restrict__ sids,
                  const int64_t* __restrict__ order, const float* __restrict__ grads,
                  int B, int width, float lr) {
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= B) return;
  // Round trip 1.  Ids are in [0, R), so -1 marks "past B" and "no previous".
  const int64_t prev = i > 0 ? sids[i - 1] : -1;
  int64_t s = i + lane < B ? sids[i + lane] : -1;
  const int64_t o0 = i + lane < B ? order[i + lane] : 0;
  const int64_t id = __shfl_sync(FULL, s, 0);
  if (prev == id) return;                  // not the head of its run
  int len = 0;
  unsigned diff = __ballot_sync(FULL, s != id);
  while (diff == 0) {                      // runs longer than 32
    len += 32;
    s = i + len + lane < B ? sids[i + len + lane] : -1;
    diff = __ballot_sync(FULL, s != id);
  }
  len += __ffs(diff) - 1;

  V* row = reinterpret_cast<V*>(table) + id * (int64_t)width;
  const V* g = reinterpret_cast<const V*>(grads);
  for (int c0 = 0; c0 < width; c0 += 32) {
    const int c = c0 + lane;
    const bool on = c < width;
    // Round trip 2: the row and the first UNROLL gradient rows, all in flight.
    const V old = on ? row[c] : zero(V());
    V buf[UNROLL];
#pragma unroll
    for (int t = 0; t < UNROLL; ++t) {
      const int64_t oj = __shfl_sync(FULL, o0, t);
      buf[t] = on && t < len ? g[oj * width + c] : zero(V());
    }
    V acc = zero(V());
#pragma unroll
    for (int t = 0; t < UNROLL; ++t)
      if (t < len) acc = add(acc, buf[t]);
    int64_t o = o0;
    for (int j0 = UNROLL; j0 < len; j0 += UNROLL) {   // runs longer than UNROLL
      if ((j0 & 31) == 0) o = i + j0 + lane < B ? order[i + j0 + lane] : 0;
#pragma unroll
      for (int t = 0; t < UNROLL; ++t) {
        const int64_t oj = __shfl_sync(FULL, o, (j0 + t) & 31);
        buf[t] = on && j0 + t < len ? g[oj * width + c] : zero(V());
      }
#pragma unroll
      for (int t = 0; t < UNROLL; ++t)
        if (j0 + t < len) acc = add(acc, buf[t]);
    }
    if (on) row[c] = step(old, lr, acc);
  }
}

}  // namespace

extern "C" int gather_fma_rows(void* table, const void* sids, const void* order,
                               const void* grads, int B, int K, float lr, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + WARPS - 1) / WARPS;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = K % 4 == 0 && ((uintptr_t)table | (uintptr_t)grads) % 16 == 0;
  if (vec)
    gather_fma_kernel<float4><<<blocks, 32 * WARPS, 0, s>>>(
        (float*)table, (const int64_t*)sids, (const int64_t*)order, (const float*)grads, B,
        K / 4, lr);
  else
    gather_fma_kernel<float><<<blocks, 32 * WARPS, 0, s>>>(
        (float*)table, (const int64_t*)sids, (const int64_t*)order, (const float*)grads, B,
        K, lr);
  return (int)cudaGetLastError();
}

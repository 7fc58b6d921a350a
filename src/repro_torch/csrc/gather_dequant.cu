// Gather + dequantize rows of an int8 embedding table, one warp per output row:
//     out[i, :] = float(q[ids[i], :]) * scale[ids[i]]
//
// Replaces the TPU kernel src/repro/kernels/embedding_update.py::gather_dequant_rows
// (body _gather_dequant_kernel), where scalar-prefetched ids drove one row DMA per
// grid step.  Here lane 0 of the warp reads the row's id and then its scale, and
// a shuffle hands both to the other lanes; each lane then converts 4 int8 values
// at a time (one 32-bit char4 load), multiplies each by the scale with one
// correctly rounded fp32 multiply (__fmul_rn: no fused or approximate
// arithmetic, so the result is bit-identical to the plain PyTorch version) and
// stores them as one float4.  K=128 is one iteration of the warp.  A row whose
// int8 start is not 4-byte aligned (K not a multiple of 4) takes the scalar path.
//
// Bound on an H100 (3.35 TB/s): bytes.  Per row it reads K bytes, a 4-byte
// scale and an 8-byte id and writes 4*K bytes: at the user gather (B=1,024,
// K=128) about 0.68 MB, 0.2 us, so it is launch-bound; at the history gather of
// AMAZON (16,384 rows) about 10.7 MB, 3.2 us.  The design keeps each row one
// warp with coalesced 4-byte loads and 16-byte stores, and the fp32 table is
// never materialized: only the gathered (B, K) block is written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                                      const int64_t* __restrict__ ids, float* __restrict__ out,
                                      int B, int K, bool vec4) {
  const int i = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= B) return;  // the whole warp leaves together
  long long id = 0;
  float s = 0.f;
  if (lane == 0) {
    id = (long long)ids[i];
    s = scale[id];
  }
  id = __shfl_sync(0xffffffffu, id, 0);
  s = __shfl_sync(0xffffffffu, s, 0);
  const int8_t* row = q + id * (long long)K;
  float* dst = out + (long long)i * K;
  if (vec4) {
    const char4* row4 = reinterpret_cast<const char4*>(row);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int c = lane; c < (K >> 2); c += 32) {
      const char4 v = row4[c];
      dst4[c] = make_float4(__fmul_rn((float)v.x, s), __fmul_rn((float)v.y, s),
                            __fmul_rn((float)v.z, s), __fmul_rn((float)v.w, s));
    }
  } else {
    for (int k = lane; k < K; k += 32) dst[k] = __fmul_rn((float)row[k], s);
  }
}

}  // namespace

extern "C" int gather_dequant_rows(const void* q, const void* scale, const void* ids, void* out,
                                   int B, int K, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const bool vec4 = (K % 4 == 0) && ((uintptr_t)q % 4 == 0) && ((uintptr_t)out % 16 == 0);
  const int threads = 256;  // 8 warps, 8 rows per block
  const int blocks = (B + 7) / 8;
  gather_dequant_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)scale, (const int64_t*)ids, (float*)out, B, K, vec4);
  return (int)cudaGetLastError();
}

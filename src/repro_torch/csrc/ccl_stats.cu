// Fused CCL similarity statistics, one block per batch row.
//
// Replaces the TPU kernel src/repro/kernels/ccl_similarity.py::ccl_stats_pallas
// (body _stats_kernel).  For row b it writes
//     uu = |u|^2, pp = |p|^2, up = u.p                       (B, 1) each
//     nn_j = |n_j|^2, un_j = u.n_j   for j < n                (B, n) each
// accumulated in fp32.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores):
// bytes.  At B=1024, n=64, K=128 the kernel must read u, p and negs once,
// 4*B*K*(n+2) = 34.6 MB, about 10 us, against 2*B*K*(2n+3) = 34.3 MFLOP,
// about 0.5 us.  The design therefore reads each input byte once: u is staged
// in shared memory, each warp streams its share of the row's negatives with
// 16-byte loads (one float4 per lane covers K=128 in one instruction), and
// the dot u.n_j runs in the same pass as |n_j|^2.  The u.n_j contraction is a
// batched GEMV (one user row against its own n negatives), so it stays on the
// CUDA cores: a tensor-core tile would have nothing to reuse.  Sums over K
// are lane partials in k order, then a warp-shuffle butterfly.  Blocks cover
// exactly the B real rows, so the ragged batch edge needs no padding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// k4: number of float4 chunks per row (0 when the rows are not 16-byte aligned).
__global__ void ccl_stats_kernel(const float* __restrict__ u, const float* __restrict__ p,
                                 const float* __restrict__ negs, float* __restrict__ uu,
                                 float* __restrict__ pp, float* __restrict__ up,
                                 float* __restrict__ nn, float* __restrict__ un,
                                 int n, int K, int k4) {
  extern __shared__ float4 smem4[];  // float4 storage keeps the float4 reads aligned
  float* su = reinterpret_cast<float*>(smem4);  // the row's user vector, K floats
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* ub = u + (size_t)b * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) su[k] = ub[k];
  __syncthreads();

  if (warp == 0) {
    const float* pb = p + (size_t)b * K;
    float a = 0.f, c = 0.f, d = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float x = su[k], y = pb[k];
      a += x * x;
      c += y * y;
      d += x * y;
    }
    a = warp_sum(a);
    c = warp_sum(c);
    d = warp_sum(d);
    if (lane == 0) {
      uu[b] = a;
      pp[b] = c;
      up[b] = d;
    }
  }

  const float4* su4 = smem4;
  for (int j = warp; j < n; j += nwarps) {
    const float* nj = negs + ((size_t)b * n + j) * K;
    const float4* nj4 = reinterpret_cast<const float4*>(nj);
    float a = 0.f, c = 0.f;
    for (int q = lane; q < k4; q += 32) {
      const float4 x = nj4[q];
      const float4 y = su4[q];
      a += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
      c += y.x * x.x + y.y * x.y + y.z * x.z + y.w * x.w;
    }
    for (int k = 4 * k4 + lane; k < K; k += 32) {
      const float x = nj[k];
      a += x * x;
      c += su[k] * x;
    }
    a = warp_sum(a);
    c = warp_sum(c);
    if (lane == 0) {
      nn[(size_t)b * n + j] = a;
      un[(size_t)b * n + j] = c;
    }
  }
}

}  // namespace

extern "C" int ccl_stats(const void* u, const void* p, const void* negs, void* uu, void* pp,
                         void* up, void* nn, void* un, int B, int n, int K, int vec,
                         void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int k4 = vec ? K / 4 : 0;
  const size_t smem = (size_t)K * sizeof(float);
  ccl_stats_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)p, (const float*)negs, (float*)uu, (float*)pp, (float*)up,
      (float*)nn, (float*)un, n, K, k4);
  return (int)cudaGetLastError();
}

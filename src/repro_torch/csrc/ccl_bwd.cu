// Analytic CCL backward (paper Eq. 4/5) from the cached statistics, one block
// per batch row.
//
// Replaces the TPU kernel src/repro/kernels/ccl_similarity.py::ccl_bwd_pallas
// (body _bwd_kernel).  From u, p, negs, the five statistics of ccl_stats.cu and
// the scalar cotangent g (already divided by B, read from device memory so the
// host never waits for it) it writes
//     du = wp*p + sum_j wn_j*n_j - coeff_u*u                 (B, K)
//     dp = wp*u - (wp*up/pp)*p                               (B, K)
//     dn_j = wn_j*u - (wn_j*un_j/nn_j)*n_j                   (B, n, K)
// with wp = -g/(|u||p|), wn_j = g*mu/n * [cos_j > theta] / (|u||n_j|) and
// coeff_u = (wp*up + sum_j wn_j*un_j)/uu.  No dot product is recomputed: the
// per-row scalars come from the stats alone.
//
// Bound on an H100 (3.35 TB/s): bytes.  At B=1024, n=64, K=128 it must read
// u, p, negs and the stats (34.9 MB) and write du, dp, dn (34.6 MB), about
// 21 us; the arithmetic (about 5*B*n*K = 42 MFLOP) is negligible.  Design:
// the block first turns the row's n statistics into the coefficients wn_j and
// wn_j*un_j/nn_j in shared memory (a fixed-order block reduction forms
// sum_j wn_j*un_j).  Then each thread owns one column k and walks j in order,
// reading negs[b, j, k] once, writing dn[b, j, k] once and accumulating du in
// a register.  Neighbouring threads touch neighbouring addresses, and every
// sum runs in a fixed order, so repeated runs give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void ccl_bwd_kernel(const float* __restrict__ u, const float* __restrict__ p,
                               const float* __restrict__ negs, const float* __restrict__ uu,
                               const float* __restrict__ pp, const float* __restrict__ up,
                               const float* __restrict__ nn, const float* __restrict__ un,
                               const float* __restrict__ g_ptr, float* __restrict__ du,
                               float* __restrict__ dp, float* __restrict__ dn, int n, int K,
                               float mu, float theta, float inv_n_negs) {
  extern __shared__ float sh[];  // wn[n], cn[n]
  __shared__ float red[32];
  float* wn = sh;
  float* cn = sh + n;
  const float eps = 1e-12f;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  const float g = *g_ptr;
  const float uue = uu[b] + eps;
  const float ppe = pp[b] + eps;
  const float upb = up[b];
  const float inv_u = 1.f / sqrtf(uue);
  const float inv_p = 1.f / sqrtf(ppe);
  const float dns_scale = g * mu * inv_n_negs;

  float part = 0.f;
  for (int j = tid; j < n; j += blockDim.x) {
    const float nne = nn[(size_t)b * n + j] + eps;
    const float unj = un[(size_t)b * n + j];
    const float inv_nn = 1.f / sqrtf(nne);
    const float neg_sim = unj * inv_u * inv_nn;
    const float d_ns = dns_scale * (neg_sim > theta ? 1.f : 0.f);
    const float w = d_ns * inv_u * inv_nn;
    wn[j] = w;
    cn[j] = w * unj / nne;
    part += w * unj;
  }
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (warp == 0) {
    float v = lane < nwarps ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float s_wnun = red[0];

  const float wp = -g * inv_u * inv_p;
  const float coeff_u = (wp * upb + s_wnun) / uue;
  const float cp = wp * upb / ppe;

  const float* ub = u + (size_t)b * K;
  const float* pb = p + (size_t)b * K;
  const float* nb = negs + (size_t)b * n * K;
  float* dnb = dn + (size_t)b * n * K;
  for (int k = tid; k < K; k += blockDim.x) {
    const float uk = ub[k];
    const float pk = pb[k];
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float x = nb[(size_t)j * K + k];
      acc += wn[j] * x;
      dnb[(size_t)j * K + k] = wn[j] * uk - cn[j] * x;
    }
    du[(size_t)b * K + k] = wp * pk + acc - coeff_u * uk;
    dp[(size_t)b * K + k] = wp * uk - cp * pk;
  }
}

}  // namespace

extern "C" int ccl_bwd(const void* u, const void* p, const void* negs, const void* uu,
                       const void* pp, const void* up, const void* nn, const void* un,
                       const void* g, void* du, void* dp, void* dn, int B, int n, int K,
                       float mu, float theta, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const size_t smem = 2 * (size_t)n * sizeof(float);
  ccl_bwd_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)p, (const float*)negs, (const float*)uu, (const float*)pp,
      (const float*)up, (const float*)nn, (const float*)un, (const float*)g, (float*)du,
      (float*)dp, (float*)dn, n, K, mu, theta, 1.0f / (float)n);
  return (int)cudaGetLastError();
}

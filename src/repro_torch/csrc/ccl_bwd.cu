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
// 21 us; the arithmetic (about 5*B*n*K = 42 MFLOP) is negligible.
//
// Design: a block of 4 warps takes one row, and the row's negatives stream
// from the block's first instructions.  Warp w owns the negatives j = w,
// w + 4, ...; lane l owns piece l of each 32-piece panel of a row, a piece
// being V floats (V = 4, one float4, when K % 4 == 0 and every pointer is
// 16-byte aligned, so a K = 128 row is one panel; otherwise V = 1).  Each
// thread copies exactly the pieces it will use, with cp.async, into its own
// slots of an 8-deep ring in shared memory, so no barrier guards the ring.
// After the row's scalars and its u and p pieces are requested, the first 8
// copies are issued; the block turns the row's n statistics into wn_j and
// wn_j*un_j/nn_j in shared memory while they arrive (one barrier); then each
// thread walks its negatives in order: wait for its oldest copy, add
// wn_j*n_j to its partial du in registers, write dn_j with one store, and
// refill the slot with the copy 8 items ahead.  At the end of a panel the
// four warps' partials are summed in warp order (one barrier), so repeated
// runs give the same bits.  A block takes about 21 KB of shared memory at
// n = 64 and 8 blocks fit an SM, so B = 1,024 rows run in one wave with up
// to 16 KB of copies in flight per block.  n up to 4,096 only lengthens the
// stream (wn and cn take 8n bytes of shared memory); other K take more panels.
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 8;  // copies in flight per thread

template <int V> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

// a*x - b*y, elementwise.
__device__ __forceinline__ float4 axmby(float a, float4 x, float b, float4 y) {
  return make_float4(a * x.x - b * y.x, a * x.y - b * y.y, a * x.z - b * y.z, a * x.w - b * y.w);
}
__device__ __forceinline__ float axmby(float a, float x, float b, float y) { return a * x - b * y; }
__device__ __forceinline__ float4 add_scaled(float4 acc, float w, float4 x) {
  return make_float4(acc.x + w * x.x, acc.y + w * x.y, acc.z + w * x.z, acc.w + w * x.w);
}
__device__ __forceinline__ float add_scaled(float acc, float w, float x) { return acc + w * x; }
__device__ __forceinline__ float4 plus(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float plus(float a, float b) { return a + b; }
// du = wp*p + acc - coeff_u*u, in the plain version's order.
__device__ __forceinline__ float4 du_of(float wp, float4 p, float4 acc, float cu, float4 u) {
  return make_float4(wp * p.x + acc.x - cu * u.x, wp * p.y + acc.y - cu * u.y,
                     wp * p.z + acc.z - cu * u.z, wp * p.w + acc.w - cu * u.w);
}
__device__ __forceinline__ float du_of(float wp, float p, float acc, float cu, float u) {
  return wp * p + acc - cu * u;
}

template <int V>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int V>
__global__ void __launch_bounds__(kThreads, 8)
ccl_bwd_kernel(const float* __restrict__ u, const float* __restrict__ p,
               const float* __restrict__ negs, const float* __restrict__ uu,
               const float* __restrict__ pp, const float* __restrict__ up,
               const float* __restrict__ nn, const float* __restrict__ un,
               const float* __restrict__ g_ptr, float* __restrict__ du, float* __restrict__ dp,
               float* __restrict__ dn, int n, int K, float mu, float theta, float inv_n_negs) {
  using T = typename Vec<V>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);             // [kStages][kThreads]
  T* part = ring + kStages * kThreads;              // [2][kWarps][32] du partials
  float* wn = reinterpret_cast<float*>(part + 2 * kThreads);
  float* cn = wn + n;
  __shared__ float red[kWarps];
  const float eps = 1e-12f;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int KV = K / V;                             // pieces of a row
  const int panels = (KV + 31) / 32;
  const int nw = warp < n ? (n - warp + kWarps - 1) / kWarps : 0;  // this warp's negatives
  const int total = panels * nw;                    // this thread's stream items

  const T* ub = reinterpret_cast<const T*>(u + (size_t)b * K);
  const T* pb = reinterpret_cast<const T*>(p + (size_t)b * K);
  const T* nb = reinterpret_cast<const T*>(negs + (size_t)b * n * K);
  T* dub = reinterpret_cast<T*>(du + (size_t)b * K);
  T* dpb = reinterpret_cast<T*>(dp + (size_t)b * K);
  T* dnb = reinterpret_cast<T*>(dn + (size_t)b * n * K);

  // The row's scalars and this lane's first u and p pieces, then the ring.
  const float g = *g_ptr;
  const float uue = uu[b] + eps;
  const float ppe = pp[b] + eps;
  const float upb = up[b];
  T u0{}, p0{};
  if (lane < KV) {
    u0 = ub[lane];
    p0 = pb[lane];
  }
  int fill_panel = 0, fill_m = 0;                   // the next item to copy
  auto fill = [&](int i) {
    if (i < total) {
      const int col = fill_panel * 32 + lane;
#ifndef PROBE_NO_LOADS
      if (col < KV)
        cp_async<V>(ring + (i % kStages) * kThreads + tid,
                    nb + (size_t)(warp + kWarps * fill_m) * KV + col);
#endif
      if (++fill_m == nw) {
        fill_m = 0;
        ++fill_panel;
      }
    }
    cp_async_commit();                              // one group per item, empty or not
  };
#pragma unroll
  for (int s = 0; s < kStages; ++s) fill(s);

  const float inv_u = 1.f / sqrtf(uue);
  const float inv_p = 1.f / sqrtf(ppe);
  const float dns_scale = g * mu * inv_n_negs;
  float part_s = 0.f;
  for (int j = tid; j < n; j += kThreads) {
    const float nne = nn[(size_t)b * n + j] + eps;
    const float unj = un[(size_t)b * n + j];
    const float inv_nn = 1.f / sqrtf(nne);
    const float neg_sim = unj * inv_u * inv_nn;
    const float d_ns = dns_scale * (neg_sim > theta ? 1.f : 0.f);
    const float w = d_ns * inv_u * inv_nn;
    wn[j] = w;
    cn[j] = w * unj / nne;
    part_s += w * unj;
  }
  part_s = warp_sum(part_s);
  if (lane == 0) red[warp] = part_s;
  __syncthreads();
  float s_wnun = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_wnun += red[w];
  const float wp = -g * inv_u * inv_p;
  const float coeff_u = (wp * upb + s_wnun) / uue;
  const float cp = wp * upb / ppe;

  int i = 0;
  for (int pnl = 0; pnl < panels; ++pnl) {
    const int col = pnl * 32 + lane;
    const bool active = col < KV;
    T uk = u0, pk = p0;
    if (pnl > 0 && active) {
      uk = ub[col];
      pk = pb[col];
    }
    T acc{};
    for (int m = 0; m < nw; ++m, ++i) {
      cp_async_wait<kStages - 1>();                 // this thread's oldest copy has landed
      if (active) {
        const int j = warp + kWarps * m;
        const float w = wn[j];
        const T x = ring[(i % kStages) * kThreads + tid];
        acc = add_scaled(acc, w, x);
#ifndef PROBE_NO_STORES
        dnb[(size_t)j * KV + col] = axmby(w, uk, cn[j], x);
#endif
      }
      fill(i + kStages);                            // after x is consumed: same slot
    }
    T* buf = part + (pnl & 1) * kThreads;           // two buffers: one barrier a panel
    buf[tid] = acc;
    __syncthreads();
    if (active && warp == 0) {
      T sum = buf[lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum = plus(sum, buf[w * 32 + lane]);
      dub[col] = du_of(wp, pk, sum, coeff_u, uk);
    } else if (active && warp == 1) {
      dpb[col] = axmby(wp, uk, cp, pk);
    }
  }
  cp_async_wait<0>();
}

template <int V>
int launch(const void* u, const void* p, const void* negs, const void* uu, const void* pp,
           const void* up, const void* nn, const void* un, const void* g, void* du, void* dp,
           void* dn, int B, int n, int K, float mu, float theta, cudaStream_t stream) {
  // The ring and the two partial buffers, then wn and cn.
  const size_t smem = (size_t)(kStages + 2) * kThreads * sizeof(typename Vec<V>::T) +
                      2 * (size_t)n * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ccl_bwd_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ccl_bwd_kernel<V><<<B, kThreads, smem, stream>>>(
      (const float*)u, (const float*)p, (const float*)negs, (const float*)uu, (const float*)pp,
      (const float*)up, (const float*)nn, (const float*)un, (const float*)g, (float*)du,
      (float*)dp, (float*)dn, n, K, mu, theta, 1.0f / (float)n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ccl_bwd(const void* u, const void* p, const void* negs, const void* uu,
                       const void* pp, const void* up, const void* nn, const void* un,
                       const void* g, void* du, void* dp, void* dn, int B, int n, int K,
                       float mu, float theta, void* stream) {
  if (B <= 0) return 0;
  bool vec = K % 4 == 0;
  for (const void* ptr : {u, p, negs, (const void*)du, (const void*)dp, (const void*)dn})
    vec = vec && (uintptr_t)ptr % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch<4>(u, p, negs, uu, pp, up, nn, un, g, du, dp, dn, B, n, K, mu, theta, s)
             : launch<1>(u, p, negs, uu, pp, up, nn, un, g, du, dp, dn, B, n, K, mu, theta, s);
}

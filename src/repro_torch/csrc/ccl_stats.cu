// Fused CCL similarity statistics for per-example negatives.
//
// Replaces the TPU kernel src/repro/kernels/ccl_similarity.py::ccl_stats_pallas
// (body _stats_kernel).  For row b it writes
//     uu = |u|^2, pp = |p|^2, up = u.p                       (B, 1) each
//     nn_j = |n_j|^2, un_j = u.n_j   for j < n                (B, n) each
// accumulated in fp32.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores):
// bytes.  At B=1024, n=64, K=128 the kernel must read u, p and negs once,
// 4*B*K*(n+2) = 34.6 MB, and write 4*B*(2n+3) = 0.5 MB, about 10.5 us,
// against 2*B*K*(2n+3) = 34.3 MFLOP, about 0.5 us.  The u.n_j contraction is
// a batched GEMV (one user row against its own n negatives): nothing to
// reuse, so it stays on the CUDA cores.
//
// Design: one warp per group of 4 consecutive negatives of a row (a row's
// negatives are contiguous, so a group is 4 contiguous rows of K floats).
// Lane l owns piece l of each 32-piece panel of a vector, a piece being V
// floats (V = 4, one float4, when K % 4 == 0 and u, p and negs are 16-byte
// aligned, so a K = 128 row is one panel; otherwise V = 1).  A warp issues
// the load of its u piece and those of its 4 negatives' pieces of a panel
// before it uses any of them, where a warp that reduces and stores one
// negative before it loads the next waits on one memory round trip per
// negative in series.  No shared memory and no barrier: u lives in one
// register piece a lane, so a warp needs about 60 registers and 16,384 warps
// of 2 KB of loads each keep every SM full.  The negatives are read once, so
// they are loaded with the evict-first hint (ld.global.cs): their lines
// leave L2 before lines that other work dirtied, whose write-back would
// otherwise share the memory bus with the stream.  Each lane forms its
// partials of the 8 values nn_j, un_j (j < 4) in k order; a transposing
// butterfly sums all 8 over the warp in 9 shuffles (against 5 for each value
// alone, 40 in all) and leaves lanes 4i..4i+3 holding value i, so lanes 0,
// 4, 8, 12 store 4 contiguous nn and lanes 16, 20, 24, 28 4 contiguous un.
// The warp of a row's first group also sums uu, pp and up.  Every sum pairs
// lanes by xor in a fixed order, so two calls give the same bits.  Blocks of
// 4 warps cover the B * ceil(n / 4) groups exactly; a short last group
// (n % 4 != 0) loads and stores only its own negatives, and any n and K only
// lengthen the grid and the panel loop.  The group size and the load hint
// were chosen on the card against 2, 8 and 16 negatives a warp and plain
// loads (tools/probe_kernels.py, part stats_mf).
//
// PROBE_NO_LOADS (no negatives read: each piece stands in as a multiple of
// u's) and PROBE_NO_STORES (nn and un kept but not written) build the
// copies that tools/probe_kernels.py times; neither is defined in the build.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                 // 4 warps a block, one group each
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;                     // negatives a warp
constexpr int kValues = 2 * kGroup;           // nn_j then un_j: one a lane when summed
constexpr unsigned kFull = 0xffffffffu;

constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }
// log2 of the lanes that end holding one value (2 here: lanes 4i..4i+3)
constexpr int kValueShift = 5 - ilog2(kValues);

template <int V> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

__device__ __forceinline__ float dot(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float dot(float a, float b) { return a * b; }

#ifdef PROBE_NO_LOADS
// Stand-ins for the negatives (no load): distinct for each j, so that no
// product is folded with another.
__device__ __forceinline__ float4 stand_in(float4 x, int j) {
  const float s = (float)(j + 1);
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}
__device__ __forceinline__ float stand_in(float x, int j) { return x * (float)(j + 1); }
#endif

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One stage of the transposing butterfly at lane offset O, while each lane
// holds 2H partial values: the lane with bit O set keeps the upper H values
// and sends the lower H to its partner, which does the opposite, and each
// adds what it receives to what it keeps.  Once one value is left, plain
// butterfly stages finish its sum.  After the stages at O = 16, 8, ..., 1
// lane l holds the warp's total of value l >> kValueShift.
template <int H, int O>
__device__ __forceinline__ void transpose_sum(float (&v)[kValues], int lane) {
  if constexpr (O > 0) {
    if constexpr (H >= 1) {
      const bool hi = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = hi ? v[i] : v[i + H];
        const float keep = hi ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      transpose_sum<H / 2, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      transpose_sum<0, O / 2>(v, lane);
    }
  }
}

// One panel: this lane's pieces of u (and p on a row's first group) and of
// the group's negatives, all requested before any is used, then their
// products added to the partials (assigned on the first panel).
template <int V, bool First>
__device__ __forceinline__ void panel(const typename Vec<V>::T* __restrict__ ub,
                                      const typename Vec<V>::T* __restrict__ pb,
                                      const typename Vec<V>::T* __restrict__ nb, int col,
                                      int KV, int cnt, bool lead, float (&v)[kValues],
                                      float& suu, float& spp, float& sup) {
  using T = typename Vec<V>::T;
  const T uk = ub[col];
  T pk{};
  if (lead) pk = pb[col];
  T x[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
#ifdef PROBE_NO_LOADS
    x[j] = stand_in(uk, j);
#else
    x[j] = j < cnt ? __ldcs(nb + (size_t)j * KV + col) : T{};
#endif
  }
  if (lead) {
    suu += dot(uk, uk);
    spp += dot(pk, pk);
    sup += dot(uk, pk);
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const float a = dot(x[j], x[j]), c = dot(uk, x[j]);
    v[j] = First ? a : v[j] + a;
    v[kGroup + j] = First ? c : v[kGroup + j] + c;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
ccl_stats_kernel(const float* __restrict__ u, const float* __restrict__ p,
                 const float* __restrict__ negs, float* __restrict__ uu,
                 float* __restrict__ pp, float* __restrict__ up,
                 float* __restrict__ nn, float* __restrict__ un, int B, int n, int K,
                 int groups) {
  using T = typename Vec<V>::T;
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)B * groups) return;     // the whole warp leaves
  const int b = (int)(w / groups);
  const int j0 = (int)(w - (long long)b * groups) * kGroup;
  const int cnt = min(kGroup, n - j0);        // this group's negatives
  const bool lead = j0 == 0;                  // also sums uu, pp, up
  const int KV = K / V;                       // pieces of a vector
  const T* ub = reinterpret_cast<const T*>(u + (size_t)b * K);
  const T* pb = reinterpret_cast<const T*>(p + (size_t)b * K);
  const T* nb = reinterpret_cast<const T*>(negs + ((size_t)b * n + j0) * K);

  float v[kValues];
#pragma unroll
  for (int i = 0; i < kValues; ++i) v[i] = 0.f;
  float suu = 0.f, spp = 0.f, sup = 0.f;
  int col = lane;
  if (col < KV) {
    panel<V, true>(ub, pb, nb, col, KV, cnt, lead, v, suu, spp, sup);
    for (col += 32; col < KV; col += 32)
      panel<V, false>(ub, pb, nb, col, KV, cnt, lead, v, suu, spp, sup);
  }

  if (lead) {
    suu = warp_sum(suu);
    spp = warp_sum(spp);
    sup = warp_sum(sup);
    if (lane == 0) {
      uu[b] = suu;
      pp[b] = spp;
      up[b] = sup;
    }
  }
  transpose_sum<kGroup, 16>(v, lane);
  const int idx = lane >> kValueShift;
  const bool is_un = idx >= kGroup;
  const int j = idx - (is_un ? kGroup : 0);
  if ((lane & ((1 << kValueShift) - 1)) == 0 && j < cnt) {
    float* out = (is_un ? un : nn) + (size_t)b * n + j0 + j;
#ifdef PROBE_NO_STORES
    if (__float_as_uint(v[0]) == 0xffffffffu)   // a NaN no finite input gives
#endif
      *out = v[0];
  }
}

template <int V>
int launch(const void* u, const void* p, const void* negs, void* uu, void* pp, void* up,
           void* nn, void* un, int B, int n, int K, cudaStream_t stream) {
  const int groups = n > 0 ? (n + kGroup - 1) / kGroup : 1;   // n == 0: uu, pp, up only
  const long long blocks = ((long long)B * groups + kWarps - 1) / kWarps;
  ccl_stats_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const float*)u, (const float*)p, (const float*)negs, (float*)uu, (float*)pp,
      (float*)up, (float*)nn, (float*)un, B, n, K, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// vec: the caller found K % 4 == 0 and u and negs 16-byte aligned; p is
// checked here too, since its pieces are loaded as wide as u's.
extern "C" int ccl_stats(const void* u, const void* p, const void* negs, void* uu, void* pp,
                         void* up, void* nn, void* un, int B, int n, int K, int vec,
                         void* stream) {
  if (B <= 0) return 0;
  const bool v4 = vec && K % 4 == 0 && (uintptr_t)u % 16 == 0 && (uintptr_t)p % 16 == 0 &&
                  (uintptr_t)negs % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  return v4 ? launch<4>(u, p, negs, uu, pp, up, nn, un, B, n, K, s)
            : launch<1>(u, p, negs, uu, pp, up, nn, un, B, n, K, s);
}

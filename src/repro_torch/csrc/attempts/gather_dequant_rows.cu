// Variants of the gather-dequant kernel (csrc/gather_dequant.cu), not
// shipped and not built by kernels/_build.py (it globs csrc/*.cu only); only
// tools/probe_kernels.py, part dequant, builds and times them.
//
// With its switches at their defaults this is the shipped kernel: a warp
// takes an output row, every lane loads the row's id, then at once the row's
// scale and the lane's V-byte piece, and stores one float4 a lane.  The
// switches are the copies the probe times: ROWS_PER_WARP consecutive rows a
// warp, every row's loads issued before any is used, and STREAMING_STORES
// (st.global.cs) for the fp32 output.  On the card two and four rows a warp
// ran slower at the step's user gather and streaming stores changed nothing
// (PERF.md, kernel #5), so the shipped kernel keeps one row a warp and plain
// stores.  The arithmetic is the shipped kernel's: one __fmul_rn an element.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ROWS_PER_WARP
#define ROWS_PER_WARP 1     // rows whose loads a warp has in flight at once
#endif
#ifndef STREAMING_STORES
#define STREAMING_STORES 0  // 1: st.global.cs (evict-first) for the fp32 output
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = ROWS_PER_WARP;

template <int V> struct Piece;
template <> struct Piece<4> { using T = int; };
template <> struct Piece<1> { using T = int8_t; };

__device__ __forceinline__ float deq(uint32_t word, int byte, float s) {
  return __fmul_rn((float)(int8_t)(word >> (8 * byte)), s);
}

// Convert one V-byte piece and store its V floats at dst.
__device__ __forceinline__ void put(float* dst, int v, float s) {
  const uint32_t w = (uint32_t)v;
  const float4 f = make_float4(deq(w, 0, s), deq(w, 1, s), deq(w, 2, s), deq(w, 3, s));
#if STREAMING_STORES
  __stcs(reinterpret_cast<float4*>(dst), f);
#else
  *reinterpret_cast<float4*>(dst) = f;
#endif
}
__device__ __forceinline__ void put(float* dst, int8_t v, float s) { *dst = __fmul_rn((float)v, s); }

template <int V>
__global__ void __launch_bounds__(kThreads, 8)
gather_dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                      const int64_t* __restrict__ ids, float* __restrict__ out, int B, int K) {
  using T = typename Piece<V>::T;
  const int lane = threadIdx.x & 31;
  const int pieces = K / V;  // pieces of a row
  const long long row0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  long long id[kRows];
  float s[kRows];
  T v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (row0 + r < B) id[r] = __ldg(ids + row0 + r);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {  // every row's loads, then any use
    if (row0 + r < B) {
      s[r] = __ldg(scale + id[r]);
      if (lane < pieces) v[r] = __ldg(reinterpret_cast<const T*>(q + id[r] * K) + lane);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row0 + r < B) {
      const T* row = reinterpret_cast<const T*>(q + id[r] * K);
      float* dst = out + (row0 + r) * K;
      if (lane < pieces) put(dst + lane * V, v[r], s[r]);
      for (int c = lane + 32; c < pieces; c += 32) put(dst + c * V, __ldg(row + c), s[r]);
    }
  }
}

template <int V>
int launch(const void* q, const void* scale, const void* ids, void* out, int B, int K,
           cudaStream_t stream) {
  const long long blocks = ((long long)B + kWarps * kRows - 1) / (kWarps * kRows);
  gather_dequant_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const int8_t*)q, (const float*)scale, (const int64_t*)ids, (float*)out, B, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gather_dequant_rows(const void* q, const void* scale, const void* ids, void* out,
                                   int B, int K, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (K % 4 == 0 && (uintptr_t)q % 4 == 0 && (uintptr_t)out % 16 == 0)
    return launch<4>(q, scale, ids, out, B, K, s);
  return launch<1>(q, scale, ids, out, B, K, s);
}

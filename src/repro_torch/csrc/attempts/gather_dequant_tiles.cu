// An attempt at the gather-dequant kernel (csrc/gather_dequant.cu), not
// shipped and not built by kernels/_build.py (it globs csrc/*.cu only); only
// tools/probe_kernels.py, part dequant, builds and times it.
//
// It followed the design first planned for the H100: a warp takes a tile of
// TILE_ROWS consecutive output rows, lane l loads the tile's id l (one
// coalesced load) and that row's scale, every row load of the tile is issued
// through a shuffle of the ids before any is used, a load is a 16-byte piece
// (8 lanes a K = 128 row, so one warp instruction reads 4 random rows) and the
// grid is at most one wave (the occupancy calculator's blocks per SM times the
// SMs, computed once per device and width), warps walking further tiles by a
// grid stride.  On the card it ran slower than the kernel it was to replace
// (PERF.md, kernel #5): instructions that span several random rows or scales,
// several rows in flight per warp, and 16-byte pieces whose float4 stores
// each fill half a 32-byte sector all cost time.  Its switches (TILE_ROWS,
// MAX_PIECE, STREAMING_STORES) are the copies the probe times.  The
// arithmetic is the shipped kernel's: one __fmul_rn an element.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef STREAMING_STORES
#define STREAMING_STORES 0  // 1: st.global.cs (evict-first) for the fp32 output
#endif
#ifndef TILE_ROWS
#define TILE_ROWS 32        // rows a warp takes at a time (at most 32)
#endif
#ifndef MAX_PIECE
#define MAX_PIECE 16        // widest piece a load takes, in bytes (16 or 4)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPieces = 8;  // pieces of rows each lane has in flight per pass
constexpr int kMaxDevices = 64;

template <int V> struct Piece;
template <> struct Piece<16> { using T = int4; };
template <> struct Piece<4> { using T = int; };
template <> struct Piece<1> { using T = int8_t; };

__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  const float4 v = make_float4(a, b, c, d);
#if STREAMING_STORES
  __stcs(reinterpret_cast<float4*>(dst), v);
#else
  *reinterpret_cast<float4*>(dst) = v;
#endif
}

__device__ __forceinline__ float deq(uint32_t word, int byte, float s) {
  return __fmul_rn((float)(int8_t)(word >> (8 * byte)), s);
}

// Convert one V-byte piece and store its V floats at dst.
template <int V>
__device__ __forceinline__ void put(float* dst, typename Piece<V>::T v, float s);

template <>
__device__ __forceinline__ void put<16>(float* dst, int4 v, float s) {
  const uint32_t w[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z, (uint32_t)v.w};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    store4(dst + 4 * c, deq(w[c], 0, s), deq(w[c], 1, s), deq(w[c], 2, s), deq(w[c], 3, s));
}

template <>
__device__ __forceinline__ void put<4>(float* dst, int v, float s) {
  const uint32_t w = (uint32_t)v;
  store4(dst, deq(w, 0, s), deq(w, 1, s), deq(w, 2, s), deq(w, 3, s));
}

template <>
__device__ __forceinline__ void put<1>(float* dst, int8_t v, float s) {
  *dst = __fmul_rn((float)v, s);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
gather_dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                      const int64_t* __restrict__ ids, float* __restrict__ out, int B, int K) {
  using T = typename Piece<V>::T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pieces = K / V;           // pieces of a row
  const int tile_pieces = TILE_ROWS * pieces;
  const int tiles = (B + TILE_ROWS - 1) / TILE_ROWS;
  for (int tile = blockIdx.x + gridDim.x * warp; tile < tiles; tile += gridDim.x * kWarps) {
    const int row0 = tile * TILE_ROWS;
    const bool mine = lane < TILE_ROWS && row0 + lane < B;
    const long long my_id = mine ? (long long)__ldg(ids + row0 + lane) : 0;
    const float my_scale = mine ? __ldg(scale + my_id) : 0.f;
    for (int base = 0; base < tile_pieces; base += 32 * kPieces) {
      T v[kPieces];
      int r[kPieces];
#pragma unroll
      for (int u = 0; u < kPieces; ++u) {  // every load of the pass, then any use
        const int it = base + 32 * u + lane;
        r[u] = it / pieces;
        const long long id = __shfl_sync(0xffffffffu, my_id, r[u] & 31);
        if (it < tile_pieces && row0 + r[u] < B)
          v[u] = __ldg(reinterpret_cast<const T*>(q + id * (long long)K) + (it - r[u] * pieces));
      }
#pragma unroll
      for (int u = 0; u < kPieces; ++u) {
        const int it = base + 32 * u + lane;
        const float s = __shfl_sync(0xffffffffu, my_scale, r[u] & 31);
        if (it < tile_pieces && row0 + r[u] < B)
          put<V>(out + (long long)(row0 + r[u]) * K + (long long)(it - r[u] * pieces) * V, v[u],
                 s);
      }
    }
  }
}

// Blocks of one full wave for width V on the current device, computed once.
template <int V>
int wave_blocks() {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_dequant_kernel<V>,
                                                      kThreads, 0) != cudaSuccess)
      return 0;
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

template <int V>
int launch(const void* q, const void* scale, const void* ids, void* out, int B, int K,
           cudaStream_t stream) {
  const int wave = wave_blocks<V>();
  if (wave == 0) return (int)cudaGetLastError();
  const int tiles = (B + TILE_ROWS - 1) / TILE_ROWS;
  const int blocks = tiles < wave ? tiles : wave;
  gather_dequant_kernel<V><<<blocks, kThreads, 0, stream>>>(
      (const int8_t*)q, (const float*)scale, (const int64_t*)ids, (float*)out, B, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gather_dequant_rows(const void* q, const void* scale, const void* ids, void* out,
                                   int B, int K, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  const uintptr_t qa = (uintptr_t)q, oa = (uintptr_t)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (MAX_PIECE >= 16 && K % 16 == 0 && qa % 16 == 0 && oa % 16 == 0) return launch<16>(q, scale, ids, out, B, K, s);
  if (K % 4 == 0 && qa % 4 == 0 && oa % 16 == 0) return launch<4>(q, scale, ids, out, B, K, s);
  return launch<1>(q, scale, ids, out, B, K, s);
}

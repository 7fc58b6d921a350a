// Gather + dequantize rows of an int8 embedding table:
//     out[i, :] = float(q[ids[i], :]) * scale[ids[i]]
//
// Replaces the TPU kernel src/repro/kernels/embedding_update.py::gather_dequant_rows
// (body _gather_dequant_kernel), where scalar-prefetched ids drove one row DMA per
// grid step.
//
// Bound on an H100 (3.35 TB/s): bytes.  Per row it reads K bytes, a 4-byte
// scale and an 8-byte id and writes 4*K bytes: at the int8 AMAZON step's user
// and positive gathers (1,024 ids, K = 128) about 0.68 MB, 0.2 us, so latency
// and launch bound; at its history gather (16,384 ids) about 10.7 MB, 3.2 us.
//
// Design: the only chain a row must wait for is id -> row, so a row's scale
// and its bytes are both requested as soon as its id is known (the kernel
// this one replaced loaded the scale first: three round trips to memory, not
// two).  A warp takes one output row: every lane loads the row's id (one
// broadcast load), then at once the row's scale and the lane's V-byte piece
// of the row (V = 4 when K % 4 == 0, q is 4-byte and out 16-byte aligned, so
// a K = 128 row is one warp instruction of 32 x 4 bytes; otherwise V = 1,
// and a row longer than 32 pieces takes further passes of the warp).  Each
// lane converts its pieces with one correctly rounded fp32 multiply per
// element (__fmul_rn: no fused or approximate arithmetic, so the result is
// bit-identical to the plain PyTorch version) and stores them, one float4 a
// lane, so a warp writes each 512-byte row whole.  Row offsets are 64-bit
// (tables past 2^31 bytes).
//
// What the card showed (tools/probe_kernels.py, part dequant, timing this
// kernel beside two unshipped variants kept in git history at commit
// 36a1c8c: several rows a warp and streaming stores, and warp tiles with
// 16-byte pieces; PERF.md, kernel #5): many independent warps with one row each beat fewer
// warps with several rows in flight, a warp instruction that spans several
// random rows or scales (16-byte pieces, 8 lanes a row) runs slower than one
// that reads one row, 16-byte pieces leave each float4 store a half-filled
// 32-byte sector (the attempt's one-wave grid did not make up for it), and
// streaming stores gain nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int V> struct Piece;
template <> struct Piece<4> { using T = int; };
template <> struct Piece<1> { using T = int8_t; };

__device__ __forceinline__ float deq(uint32_t word, int byte, float s) {
  return __fmul_rn((float)(int8_t)(word >> (8 * byte)), s);
}

// Convert one V-byte piece and store its V floats at dst.
__device__ __forceinline__ void put(float* dst, int v, float s) {
  const uint32_t w = (uint32_t)v;
  *reinterpret_cast<float4*>(dst) =
      make_float4(deq(w, 0, s), deq(w, 1, s), deq(w, 2, s), deq(w, 3, s));
}
__device__ __forceinline__ void put(float* dst, int8_t v, float s) { *dst = __fmul_rn((float)v, s); }

template <int V>
__global__ void __launch_bounds__(kThreads, 8)
gather_dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                      const int64_t* __restrict__ ids, float* __restrict__ out, int B, int K) {
  using T = typename Piece<V>::T;
  const int lane = threadIdx.x & 31;
  const int pieces = K / V;  // pieces of a row
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;
  const long long id = __ldg(ids + row);
  const T* src = reinterpret_cast<const T*>(q + id * K);
  const float s = __ldg(scale + id);  // the scale and the row's first piece
  T v;                                // are both requested before either is used
  if (lane < pieces) v = __ldg(src + lane);
  float* dst = out + row * K;
  if (lane < pieces) put(dst + lane * V, v, s);
  for (int c = lane + 32; c < pieces; c += 32) put(dst + c * V, __ldg(src + c), s);
}

template <int V>
int launch(const void* q, const void* scale, const void* ids, void* out, int B, int K,
           cudaStream_t stream) {
  const long long blocks = ((long long)B + kWarps - 1) / kWarps;
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

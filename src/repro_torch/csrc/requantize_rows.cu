// Stochastic requantize of an int8 table's updated rows, in place, for the
// live segments of the update only:
//     new = float(q[id]) * scale[id] + float(err[id]) * err_scale[id] - lr * g[j]
//     scale[id] = max(absmax(new) * (1 / 127), floor)
//     q[id]     = clamp(floor(new / scale[id] + u[j]), -127, 127)
//     r         = new - float(q[id]) * scale[id]
//     err_scale[id] = max(absmax(r) * (1 / 127), floor)
//     err[id]   = clamp(round_half_even(r / err_scale[id]), -127, 127)
// for each segment j < nseg of the duplicate pre-reduce, id = uids[j], g its
// gradient sum (reduced[j]) and u noise row j.
//
// Replaces no TPU kernel.  It replaces, on the card, the plain requantize of
// optim/quantization.py::apply_updates (kept in kernels/requantize_rows.py as
// the plain version) and its four index_put_ scatters.  Those ran over every
// lane of the update, b of them, though only the first nseg = seg[b-1] + 1
// hold a segment: at the int8 item update of batch 16,384, b = 1,655,808 and
// ~1.59M lanes are the history's padding (item 0), one segment, so ~96% of
// the work and the scatters' writes were thrown away (every lane of a run
// wrote its segment's values).  Here nseg is read on the card, so there is no
// readback, and the grid strides over j < nseg: the dead lanes cost no block.
//
// Bits: every operation is the plain version's, in its order, rounded the way
// PyTorch's CUDA kernels round it: no FMA contraction (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn); floorf for the stochastic floor and rintf for
// torch.round; clamps that pass a NaN through; and `absmax / 127.0`, a tensor
// over a Python scalar, computed as PyTorch's CUDA division computes it, a
// multiply by the float reciprocal 1.0f / 127.0f (one ulp from a division on
// some values; tests/test_torch_requantize.py pins it on the card).  The
// absmax is a warp-shuffle maximum that propagates NaN, as torch.amax does.
//
// Bound on an H100 (3.35 TB/s): bytes.  A segment reads its id (8 B), its
// gradient sum and noise row (4K B each), its payload and residual rows
// (K B each) and two scales, and writes the two rows and the two scales:
// 12K + 24 bytes, 1,560 at K = 128.  At ~53k-66.5k live segments of the
// b16,384 item update, 83-104 MB, 25-31 us.
//
// Design: one warp a segment; each lane holds NP float4 pieces of the row
// (K % 4 == 0, K <= 128 * NP), so a K = 128 row is one char4 or float4 a lane
// and both absmaxes are 5-step butterflies of __shfl_xor_sync.  The segment's
// id is the only load the row waits on; the gradient sum and the noise are
// requested beside it, and the next segment's id is requested before this
// segment's work.  The grid is fixed (a few blocks an SM) and strides over the
// live segments.  Each live segment's id is distinct, so each row is read and
// written by exactly one warp: no atomics on the table.  One int64 atomic a
// launch adds nseg to *requantized (a counter the step never reads).  Row
// offsets are 64-bit (tables past 2^31 bytes).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned FULL = 0xffffffffu;

// max(a, b) that returns a NaN if either is one (torch.amax propagates NaN).
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_nanmax(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = nanmax(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// torch.clamp_min(v, lo) on the card: a NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// torch.clamp(v, -127, 127) then .to(int8); v is integral or NaN.
__device__ __forceinline__ int8_t to_int8(float v) {
  if (v == v) v = fminf(fmaxf(v, -127.f), 127.f);
  return (int8_t)__float2int_rz(v);
}

__device__ __forceinline__ float absmax4(float4 v) {
  return nanmax(nanmax(fabsf(v.x), fabsf(v.y)), nanmax(fabsf(v.z), fabsf(v.w)));
}

template <int NP>
__global__ void __launch_bounds__(kThreads)
requantize_rows_kernel(int8_t* q, float* scale, int8_t* err, float* err_scale,
                       const int64_t* __restrict__ seg, const int64_t* __restrict__ uids,
                       const float* __restrict__ reduced, const float* __restrict__ noise,
                       unsigned long long* __restrict__ requantized, int64_t b, int K,
                       float lr, float inv127, float floor_) {
  const int lane = threadIdx.x & 31;
  const int pieces = K / 4;
  const int64_t nseg = seg[b - 1] + 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(requantized, (unsigned long long)nseg);
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  int64_t j = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  int64_t id = j < nseg ? uids[j] : 0;
  for (; j < nseg; j += stride) {
    const int64_t next = j + stride < nseg ? uids[j + stride] : 0;
    const float4* g4 = reinterpret_cast<const float4*>(reduced + j * K);
    const float4* u4 = reinterpret_cast<const float4*>(noise + j * K);
    char4* q4 = reinterpret_cast<char4*>(q + id * K);
    char4* e4 = reinterpret_cast<char4*>(err + id * K);
    const float s = scale[id], es = err_scale[id];
    float4 row[NP], u[NP];
    float m = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int c = lane + 32 * p;
      if (c < pieces) {
        const float4 g = g4[c];
        u[p] = u4[c];
        const char4 qv = q4[c], ev = e4[c];
        // (rows + resid) - (lr * g), each operation rounded on its own
        row[p].x = __fsub_rn(__fadd_rn(__fmul_rn((float)qv.x, s), __fmul_rn((float)ev.x, es)),
                             __fmul_rn(g.x, lr));
        row[p].y = __fsub_rn(__fadd_rn(__fmul_rn((float)qv.y, s), __fmul_rn((float)ev.y, es)),
                             __fmul_rn(g.y, lr));
        row[p].z = __fsub_rn(__fadd_rn(__fmul_rn((float)qv.z, s), __fmul_rn((float)ev.z, es)),
                             __fmul_rn(g.z, lr));
        row[p].w = __fsub_rn(__fadd_rn(__fmul_rn((float)qv.w, s), __fmul_rn((float)ev.w, es)),
                             __fmul_rn(g.w, lr));
        m = nanmax(m, absmax4(row[p]));
      }
    }
    const float ns = clamp_min(__fmul_rn(warp_nanmax(m), inv127), floor_);
    char4 qn[NP];
    float me = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (lane + 32 * p < pieces) {
        qn[p].x = to_int8(floorf(__fadd_rn(__fdiv_rn(row[p].x, ns), u[p].x)));
        qn[p].y = to_int8(floorf(__fadd_rn(__fdiv_rn(row[p].y, ns), u[p].y)));
        qn[p].z = to_int8(floorf(__fadd_rn(__fdiv_rn(row[p].z, ns), u[p].z)));
        qn[p].w = to_int8(floorf(__fadd_rn(__fdiv_rn(row[p].w, ns), u[p].w)));
        // the residual, kept in row[]
        row[p].x = __fsub_rn(row[p].x, __fmul_rn((float)qn[p].x, ns));
        row[p].y = __fsub_rn(row[p].y, __fmul_rn((float)qn[p].y, ns));
        row[p].z = __fsub_rn(row[p].z, __fmul_rn((float)qn[p].z, ns));
        row[p].w = __fsub_rn(row[p].w, __fmul_rn((float)qn[p].w, ns));
        me = nanmax(me, absmax4(row[p]));
      }
    }
    const float nes = clamp_min(__fmul_rn(warp_nanmax(me), inv127), floor_);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int c = lane + 32 * p;
      if (c < pieces) {
        char4 eq;
        eq.x = to_int8(rintf(__fdiv_rn(row[p].x, nes)));
        eq.y = to_int8(rintf(__fdiv_rn(row[p].y, nes)));
        eq.z = to_int8(rintf(__fdiv_rn(row[p].z, nes)));
        eq.w = to_int8(rintf(__fdiv_rn(row[p].w, nes)));
        q4[c] = qn[p];
        e4[c] = eq;
      }
    }
    if (lane == 0) {
      scale[id] = ns;
      err_scale[id] = nes;
    }
    id = next;
  }
}

template <int NP>
int launch(void* q, void* scale, void* err, void* err_scale, const void* seg, const void* uids,
           const void* reduced, const void* noise, void* requantized, int64_t b, int K,
           float lr, float floor_, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, requantize_rows_kernel<NP>,
                                                      kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  // One wave of resident blocks, fewer where the update has fewer lanes.
  const int64_t want = (b + kWarps - 1) / kWarps;
  const int64_t wave = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(want < wave ? want : wave);
  requantize_rows_kernel<NP><<<blocks, kThreads, 0, stream>>>(
      (int8_t*)q, (float*)scale, (int8_t*)err, (float*)err_scale, (const int64_t*)seg,
      (const int64_t*)uids, (const float*)reduced, (const float*)noise,
      (unsigned long long*)requantized, b, K, lr, 1.0f / 127.0f, floor_);
  return (int)cudaGetLastError();
}

}  // namespace

// q, err (R, K) int8 and scale, err_scale (R, 1) fp32: the table, written in
// place; seg, uids (b,) int64, reduced and noise (b, K) fp32; requantized one
// int64 that the kernel adds nseg to.  K % 4 == 0 and K <= 1,024 (the wrapper
// raises otherwise), q and err 4-byte and reduced and noise 16-byte aligned.
extern "C" int requantize_rows(void* q, void* scale, void* err, void* err_scale,
                               const void* seg, const void* uids, const void* reduced,
                               const void* noise, void* requantized, long long b, int K,
                               float lr, float scale_floor, void* stream) {
  if (b <= 0) return 0;
  if (K <= 0 || K % 4 != 0 || K > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (K <= 128)
    return launch<1>(q, scale, err, err_scale, seg, uids, reduced, noise, requantized, b, K,
                     lr, scale_floor, st);
  if (K <= 256)
    return launch<2>(q, scale, err, err_scale, seg, uids, reduced, noise, requantized, b, K,
                     lr, scale_floor, st);
  if (K <= 512)
    return launch<4>(q, scale, err, err_scale, seg, uids, reduced, noise, requantized, b, K,
                     lr, scale_floor, st);
  return launch<8>(q, scale, err, err_scale, seg, uids, reduced, noise, requantized, b, K, lr,
                   scale_floor, st);
}

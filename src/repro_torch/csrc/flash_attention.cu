// Block-wise (flash) attention forward, causal or full, with GQA, fp32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel).  q (B, Hq, S, D), k and v
// (B, Hkv, S, D), Hq a multiple of Hkv -> o (B, Hq, S, D):
//     o = softmax(scale * q k^T [causal mask]) v
// with the online softmax: a running max m, denominator l and accumulator
// per query row, rescaled by exp(m_old - m_new) at every key tile, and
// finalized as acc / max(l, 1e-30), as the reference does.  Masked logits
// are -1e30, as in the reference.
//
// Bound on an H100 (67 TFLOP/s fp32 outside the tensor cores): operations.
// At smollm-360m's shape (B=8, Hq=15, Hkv=5, S=1,024, D=64) the causal
// forward needs about 4*B*Hq*S*S*D/2 = 16 GFLOP (half the key tiles), about
// 240 us, against 50 MB of q, k, v and o, about 15 us.  The TPU kernel keeps
// its running statistics in VMEM scratch across a sequential key grid axis;
// here one block of 4 warps takes one (batch, query head, 64-query tile) and
// loops over the 64-key tiles itself, so the statistics stay in registers:
// each warp owns 16 query rows, each lane two keys of a tile for the scores
// and D/32 output columns for the accumulator.  K is staged transposed
// (padded, so neither the transposing store nor the reads conflict on a
// bank), V and Q row-major; the probabilities go through shared memory so
// that P.V reads them as float4 broadcasts.  Tiles strictly above the
// diagonal are skipped when causal.  GQA reads KV head h / (Hq/Hkv) without
// materializing repeats.  Sums are in a fixed order (the dot over D in
// order, keys in order), so repeats give the same bits.  S must be a
// multiple of 64 and D one of 32, 64, 128; the wrapper checks both.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BKT = 64;      // keys per tile
constexpr int ROWS = 16;     // query rows per warp
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * D + (size_t)D * (BKT + 1) + (size_t)BKT * D +
                          (size_t)(THREADS / 32) * ROWS * BKT);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Hq, int Hkv, int S,
                 float scale, int causal) {
  constexpr int DV = D / 32;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                         // [BQ][D]
  float* kT = qs + BQ * D;                // [D][BKT + 1]
  float* vs = kT + D * (BKT + 1);         // [BKT][D]
  float* ps = vs + BKT * D;               // [warps][ROWS][BKT]
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qbase = (((size_t)b * Hq + h) * S + (size_t)qt * BQ) * D;
  const size_t kvbase = ((size_t)b * Hkv + hk) * (size_t)S * D;
  float* pw = ps + warp * ROWS * BKT;

  for (int i = tid; i < BQ * D; i += THREADS) qs[i] = q[qbase + i];

  float m[ROWS], l[ROWS], acc[ROWS][DV];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DV; ++c) acc[r][c] = 0.f;
  }

  const int nkt = causal ? qt + 1 : S / BKT;
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();   // the previous tile's K and V are no longer read
    const size_t tbase = kvbase + (size_t)kt * BKT * D;
    for (int i = tid; i < BKT * D; i += THREADS) {
      const int key = i / D, d = i % D;
      kT[d * (BKT + 1) + key] = k[tbase + i];
      vs[i] = v[tbase + i];
    }
    __syncthreads();

    float s0[ROWS], s1[ROWS];   // keys lane and lane + 32
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s0[r] = s1[r] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float k0[4], k1[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        k0[t] = kT[(d + t) * (BKT + 1) + lane];
        k1[t] = kT[(d + t) * (BKT + 1) + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&qs[(warp * ROWS + r) * D + d]);
        s0[r] = fmaf(qv.x, k0[0], s0[r]);
        s0[r] = fmaf(qv.y, k0[1], s0[r]);
        s0[r] = fmaf(qv.z, k0[2], s0[r]);
        s0[r] = fmaf(qv.w, k0[3], s0[r]);
        s1[r] = fmaf(qv.x, k1[0], s1[r]);
        s1[r] = fmaf(qv.y, k1[1], s1[r]);
        s1[r] = fmaf(qv.z, k1[2], s1[r]);
        s1[r] = fmaf(qv.w, k1[3], s1[r]);
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = qt * BQ + warp * ROWS + r;
      float a = s0[r] * scale, c = s1[r] * scale;
      if (causal) {
        if (kt * BKT + lane > qpos) a = NEG_INF;
        if (kt * BKT + lane + 32 > qpos) c = NEG_INF;
      }
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c2 = 0; c2 < DV; ++c2) acc[r][c2] *= alpha;
      pw[r * BKT + lane] = pa;
      pw[r * BKT + lane + 32] = pc;
    }
    __syncwarp();

    for (int j = 0; j < BKT; j += 4) {
      float vv[4][DV];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c2 = 0; c2 < DV; ++c2) vv[t][c2] = vs[(j + t) * D + lane + 32 * c2];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 pr = *reinterpret_cast<const float4*>(&pw[r * BKT + j]);
#pragma unroll
        for (int c2 = 0; c2 < DV; ++c2) {
          float a = acc[r][c2];
          a = fmaf(pr.x, vv[0][c2], a);
          a = fmaf(pr.y, vv[1][c2], a);
          a = fmaf(pr.z, vv[2][c2], a);
          a = fmaf(pr.w, vv[3][c2], a);
          acc[r][c2] = a;
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c2 = 0; c2 < DV; ++c2)
      o[qbase + (size_t)(warp * ROWS + r) * D + lane + 32 * c2] = acc[r][c2] / denom;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int B, int Hq, int Hkv,
           int S, float scale, int causal, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(S / BQ, Hq, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, s>>>(q, k, v, o, Hq, Hkv, S, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int Hq, int Hkv, int S, int D, float scale,
                                   int causal, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)o;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(qf, kf, vf, of, B, Hq, Hkv, S, scale, causal, s);
    case 64: return launch<64>(qf, kf, vf, of, B, Hq, Hkv, S, scale, causal, s);
    case 128: return launch<128>(qf, kf, vf, of, B, Hq, Hkv, S, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

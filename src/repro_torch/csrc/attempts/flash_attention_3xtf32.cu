// NOT SHIPPED: the split-TF32 attempt at csrc/flash_attention.cu, kept for
// tools/probe_kernels.py (part "flash"); see README.md here and PERF.md.  It
// meets the kernel tolerance on unit-normal q, k, v but not where logits are
// large (the model's own q, k, v), so the shipped kernel keeps fp32 FMAs.
//
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
// Bound on an H100.  At smollm-360m's shape (B=8, Hq=15, Hkv=5, S=1,024,
// D=64) the causal forward needs 4*B*Hq*D*S(S+1)/2 = 16.1 GFLOP and moves
// 84 MB (q and o 31.5 MB each, k and v 10.5 MB each), about 25 us at 3.35
// TB/s.  On the fp32 SIMT pipes (67 TFLOP/s) the operations take 240.6 us;
// this kernel runs both products on the tensor cores in split TF32
// ("3xTF32": three TF32 products per fp32 product), 48.4 GFLOP of TF32
// work, at least 97.6 us at the dense TF32 peak of 495 TFLOP/s.  So it is
// bound by operations on the tensor cores.
//
// Accuracy: TF32 keeps 10 bits of mantissa, too few for the kernel
// tolerance of 1e-6 + 1e-5*|plain|.  Each fp32 operand x is split as
// hi = tf32(x), lo = tf32(x - hi) (x - hi is exact in fp32; both rounded to
// nearest), and a product is taken as lo*hi + hi*lo + hi*hi; the dropped
// lo*lo term and lo's rounding leave about 2^-22 of each product.  The
// tensor cores' fp32 accumulation does not round to nearest (its error is
// biased), so long chains of MMAs into one accumulator drift past the
// tolerance even on unit-normal inputs.  So every k step of S = q k^T is
// summed in a fresh accumulator (three MMAs) and added to S in fp32, and
// each key tile's P v likewise, folded in as o = o * alpha + (P v).
//
// Design:
// - One block of 4 warps takes one (batch, query head, 64-query tile) and
//   walks the 32-key tiles itself, so the softmax statistics stay in
//   registers; each warp owns 16 query rows: one m16 row of
//   mma.sync.m16n8k8 tiles.  Q is split once per block into hi and lo
//   tiles in shared memory, and each K and V tile once as it lands (hi in
//   place, lo beside it), so the warps only load fragments.
// - Fragments: a lane's two k slots of an m16n8k8 (q and q + 4, q = lane %
//   4) are given the consecutive k 2q and 2q + 1 of each 8-wide k step,
//   which is free because a product only needs A and B to agree on k.
//   Then Q and K fragments are single 8-byte shared loads, and the S tile's
//   accumulator fragment is already P's A fragment for P.V: no shuffles and
//   no trip of P through shared memory.  Row strides of D + 8 (Q, K) and
//   D + 4 (V) floats keep the fragment loads free of bank conflicts.
// - Loads: K and V tiles stream through a two-stage cp.async ring (16-byte
//   copies, .cg), tile kt + 1 in flight while tile kt is split and computed.
// - Causal order: the grid is one-dimensional and hands out the heaviest
//   query tiles (the most key tiles) first, so the last blocks to start are
//   the light ones and the tail is short.  Tiles strictly above the
//   diagonal are skipped; only the tiles the diagonal crosses are masked.
// - GQA reads KV head h / (Hq/Hkv) without materializing repeats; blocks of
//   one batch and neighbouring heads run together and share K and V in L2.
// - Sums are in a fixed order (MMAs in a fixed sequence, the row sums over
//   the quad's lanes in a fixed shuffle order), so repeats give the same
//   bits.  S must be a multiple of 64 and D one of 32, 64, 128; the wrapper
//   checks both.
// Shared memory: 2 * 64 * (D + 8) floats of Q (hi, lo) plus two stages of
// K (2 * 32 * (D + 8), hi and lo) and V (2 * 32 * (D + 4)): 58 KB at D = 32,
// 106 KB at D = 64 (two blocks per SM), 202 KB at D = 128 (one).
// What bounds it: the MMAs.  mma.sync issues TF32 well below the tensor
// cores' wgmma rate, and this kernel needs three per fp32 product.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BKT = 32;      // keys per tile
constexpr int WARPS = 4;     // 16 query rows each
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;    // Q hi / lo and K row strides (floats)
  static constexpr int LDV = D + 4;    // V row stride
  static constexpr int Q_FLOATS = BQ * LDQ;
  static constexpr int K_FLOATS = BKT * LDQ;
  static constexpr int V_FLOATS = BKT * LDV;
  static constexpr int STAGE_FLOATS = 2 * (K_FLOATS + V_FLOATS);   // k, k lo, v, v lo
  static constexpr size_t BYTES = sizeof(float) * (2 * Q_FLOATS + 2 * STAGE_FLOATS);
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 of x, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// Four floats at hi (16-byte aligned) split in place: hi keeps tf32(x), lo
// gets tf32(x - hi).
__device__ __forceinline__ void split4(float* hi, float* lo) {
  const float4 x = *reinterpret_cast<const float4*>(hi);
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  *reinterpret_cast<float4*>(hi) = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                                               __uint_as_float(h[2]), __uint_as_float(h[3]));
  *reinterpret_cast<float4*>(lo) = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                                               __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// D (16x8) += A (16x8, row) * B (8x8, col), TF32 in, fp32 accumulate.
// Fragments (g = lane / 4, q = lane % 4): a = {A[g][kq], A[g+8][kq],
// A[g][kq'], A[g+8][kq']}, b = {B[kq][g], B[kq'][g]}, d = {D[g][2q],
// D[g][2q+1], D[g+8][2q], D[g+8][2q+1]}, where this kernel names the slots
// kq = 2q and kq' = 2q + 1 (see the header).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = A * B with a zero accumulator (a fresh partial sum).
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// d = (fresh ? 0 : d) + A * B.
__device__ __forceinline__ void mma_part(float (&d)[4], bool fresh, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if (fresh)
    mma_tf32_zero(d, a, b0, b1);
  else
    mma_tf32(d, a, b0, b1);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

template <int D>
__global__ void __launch_bounds__(THREADS, (D <= 64 ? 2 : 1))
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int B, int Hq, int Hkv,
                 int S, float scale, int causal) {
  using L = Layout<D>;
  constexpr int LDQ = L::LDQ, LDV = L::LDV;
  constexpr int DT = D / 8;                 // 8-wide column tiles of the output
  constexpr int DC = DT < 8 ? DT : 8;       // column tiles per V fragment batch
  constexpr int KN = BKT / 8;               // 8-key tiles of a key tile
  extern __shared__ __align__(16) float sm[];
  float* qh_s = sm;                         // [BQ][LDQ], tf32 hi of q
  float* ql_s = qh_s + L::Q_FLOATS;         // [BQ][LDQ], tf32 lo of q
  // 2 stages of [BKT][LDQ] k (its tf32 hi once split), [BKT][LDQ] k lo,
  // [BKT][LDV] v (hi), [BKT][LDV] v lo.
  float* ring = ql_s + L::Q_FLOATS;

  // Heaviest query tiles first (causal): tile index runs down the grid.
  const int nqt = S / BQ;
  const int nbh = Hq * B;
  const int qt_rank = blockIdx.x / nbh;
  const int qt = causal ? nqt - 1 - qt_rank : qt_rank;
  const int bh = blockIdx.x % nbh;
  const int h = bh % Hq, b = bh / Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const size_t qbase = (((size_t)b * Hq + h) * S + (size_t)qt * BQ) * D;
  const size_t kvbase = ((size_t)b * Hkv + hk) * (size_t)S * D;
  const int nkt = causal ? (qt + 1) * (BQ / BKT) : S / BKT;

  auto load_kv = [&](int kt) {
    float* ks = ring + (kt & 1) * L::STAGE_FLOATS;
    float* vs = ks + 2 * L::K_FLOATS;
    const float* kg = k + kvbase + (size_t)kt * BKT * D;
    const float* vg = v + kvbase + (size_t)kt * BKT * D;
    for (int i = tid; i < BKT * D / 4; i += THREADS) {
      const int r = i / (D / 4), c = 4 * (i % (D / 4));
      cp_async16(ks + r * LDQ + c, kg + (size_t)r * D + c);
      cp_async16(vs + r * LDV + c, vg + (size_t)r * D + c);
    }
  };

  load_kv(0);
  cp_async_commit();
  // q, split once: hi and lo tiles.
  for (int i = tid; i < BQ * D / 4; i += THREADS) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4));
    const float4 x = *reinterpret_cast<const float4*>(q + qbase + (size_t)r * D + c);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t hi, lo;
      split(xs[j], hi, lo);
      qh_s[r * LDQ + c + j] = __uint_as_float(hi);
      ql_s[r * LDQ + c + j] = __uint_as_float(lo);
    }
  }

  float oacc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;     // rows g and g + 8 of the warp
  float l0 = 0.f, l1 = 0.f;             // this lane's part of the row sums
  const int r0 = warp * 16 + g;         // the lane's first row in the block
  const int qpos0 = qt * BQ + r0;

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait_all();
    __syncthreads();   // tile kt (and q) visible; tile kt-1's stage is free
    if (kt + 1 < nkt) load_kv(kt + 1);
    cp_async_commit();
    float* ks = ring + (kt & 1) * L::STAGE_FLOATS;
    float* kls = ks + L::K_FLOATS;
    float* vs = kls + L::K_FLOATS;
    float* vls = vs + L::V_FLOATS;
    // Split the tile once for all warps: hi in place, lo beside it.
    for (int i = tid; i < BKT * D / 4; i += THREADS) {
      const int r = i / (D / 4), c = 4 * (i % (D / 4));
      split4(ks + r * LDQ + c, kls + r * LDQ + c);
      split4(vs + r * LDV + c, vls + r * LDV + c);
    }
    __syncthreads();   // the split tile visible

    // S = q k^T for the warp's 16 rows x BKT keys: KN n tiles of 8 keys.
    float s[KN][4];
#pragma unroll
    for (int nt = 0; nt < KN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c = 8 * kk + 2 * qd;
      const float2 h0 = *reinterpret_cast<const float2*>(qh_s + r0 * LDQ + c);
      const float2 h1 = *reinterpret_cast<const float2*>(qh_s + (r0 + 8) * LDQ + c);
      const float2 w0 = *reinterpret_cast<const float2*>(ql_s + r0 * LDQ + c);
      const float2 w1 = *reinterpret_cast<const float2*>(ql_s + (r0 + 8) * LDQ + c);
      const uint32_t ah[4] = {__float_as_uint(h0.x), __float_as_uint(h1.x),
                              __float_as_uint(h0.y), __float_as_uint(h1.y)};
      const uint32_t al[4] = {__float_as_uint(w0.x), __float_as_uint(w1.x),
                              __float_as_uint(w0.y), __float_as_uint(w1.y)};
      uint32_t bh[KN][2], bl[KN][2];
#pragma unroll
      for (int nt = 0; nt < KN; ++nt) {
        const float2 x = *reinterpret_cast<const float2*>(ks + (8 * nt + g) * LDQ + c);
        const float2 y = *reinterpret_cast<const float2*>(kls + (8 * nt + g) * LDQ + c);
        bh[nt][0] = __float_as_uint(x.x);
        bh[nt][1] = __float_as_uint(x.y);
        bl[nt][0] = __float_as_uint(y.x);
        bl[nt][1] = __float_as_uint(y.y);
      }
      float part[KN][4];          // this k step's three products, then added
#pragma unroll
      for (int nt = 0; nt < KN; ++nt) mma_tf32_zero(part[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int nt = 0; nt < KN; ++nt) mma_tf32(part[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
      for (int nt = 0; nt < KN; ++nt) mma_tf32(part[nt], ah, bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int nt = 0; nt < KN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += part[nt][e];
    }

    // Scale, mask the diagonal tile, and the online softmax of rows g, g+8.
    const bool diag = causal && (kt + 1) * BKT > qt * BQ;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < KN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (diag) {
          const int key = kt * BKT + 8 * nt + 2 * qd + (e & 1);
          if (key > qpos0 + (e < 2 ? 0 : 8)) x = NEG_INF;
        }
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < KN; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;

    // o = o * alpha + P v, the tile's P v summed apart (pv) and added in
    // fp32: P's A fragment of key step kk is S's n tile kk as it stands.
    float pv[DT][4];
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      uint32_t ph[4], pl[4];
      split(s[kk][0], ph[0], pl[0]);
      split(s[kk][2], ph[1], pl[1]);
      split(s[kk][1], ph[2], pl[2]);
      split(s[kk][3], ph[3], pl[3]);
      const float* v0 = vs + (8 * kk + 2 * qd) * LDV + g;
      const float* w0 = vls + (8 * kk + 2 * qd) * LDV + g;
#pragma unroll
      for (int d0 = 0; d0 < DT; d0 += DC) {
        uint32_t bh[DC][2], bl[DC][2];
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          bh[j][0] = __float_as_uint(v0[8 * (d0 + j)]);
          bh[j][1] = __float_as_uint(v0[LDV + 8 * (d0 + j)]);
          bl[j][0] = __float_as_uint(w0[8 * (d0 + j)]);
          bl[j][1] = __float_as_uint(w0[LDV + 8 * (d0 + j)]);
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) mma_part(pv[d0 + j], kk == 0, pl, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < DC; ++j) mma_tf32(pv[d0 + j], ph, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < DC; ++j) mma_tf32(pv[d0 + j], ph, bh[j][0], bh[j][1]);
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      oacc[dt][0] = fmaf(oacc[dt][0], alpha0, pv[dt][0]);
      oacc[dt][1] = fmaf(oacc[dt][1], alpha0, pv[dt][1]);
      oacc[dt][2] = fmaf(oacc[dt][2], alpha1, pv[dt][2]);
      oacc[dt][3] = fmaf(oacc[dt][3], alpha1, pv[dt][3]);
    }
  }
  cp_async_wait_all();

  // Row sums over the quad's 4 lanes, then o = acc / max(l, 1e-30).
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  float* o0 = o + qbase + (size_t)r0 * D + 2 * qd;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    *reinterpret_cast<float2*>(o0 + 8 * dt) =
        make_float2(oacc[dt][0] / den0, oacc[dt][1] / den0);
    *reinterpret_cast<float2*>(o0 + 8 * D + 8 * dt) =
        make_float2(oacc[dt][2] / den1, oacc[dt][3] / den1);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int B, int Hq, int Hkv,
           int S, float scale, int causal, cudaStream_t s) {
  constexpr size_t smem = Layout<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)(S / BQ) * (unsigned)Hq * (unsigned)B;
  flash_fwd_kernel<D><<<blocks, THREADS, smem, s>>>(q, k, v, o, B, Hq, Hkv, S, scale, causal);
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

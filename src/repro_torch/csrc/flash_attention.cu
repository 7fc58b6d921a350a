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
// forward needs 4*B*Hq*D*S(S+1)/2 = 16.1 GFLOP, 240.6 us, and moves 84 MB
// (q and o 31.5 MB each, k and v 10.5 MB each), about 25 us at 3.35 TB/s.
//
// Arithmetic: fp32 FMAs on the SIMT pipes.  Split TF32 on the tensor cores
// ("3xTF32", kept in git history at commit 162143c and measured by
// tools/probe_kernels.py there) ran in 450 us but missed the kernel tolerance on
// the model's own q, k, v, whose logits are large: each product keeps about
// 2^-21 of its size there against fp32's 2^-24 (PERF.md).
//
// Design:
// - One block of 4 warps takes one (batch, query head, 64-query tile) and
//   walks the 64-key tiles itself, so the softmax statistics stay in
//   registers.  Both products use a 2-D register tile: thread (rg, kg),
//   rg = 0..15 and kg = 0..7, owns query rows rg + 16i (i < 4); for S =
//   q k^T it owns keys kg + 8j (j < 8), 32 logits from 12 16-byte shared
//   loads per 4 steps of d (128 FMAs); for o += P v it owns output columns
//   4kg + 32c (4 a float4), again 4 rows at once.  A warp's lanes share 4
//   row groups and 8 key (column) groups, so q and P loads are broadcasts
//   and K and V loads are 8 distinct 16-byte pieces: each load is one
//   shared-memory wavefront, and the FMAs outnumber the load wavefronts
//   about 2.7 to 1.  Row strides of D + 4 (q, K, V) and 64 + 4 (P) floats
//   keep them free of bank conflicts.
// - The row max and sum are reduced over the 8 lanes of a row group (all in
//   one warp), and P goes through shared memory in the warp's own rows, so
//   only K and V are shared between warps.
// - Loads: K and V tiles stream through a two-stage cp.async ring (16-byte
//   copies, .cg), tile kt + 1 in flight while tile kt computes.
// - Causal order: the grid is one-dimensional and hands out the heaviest
//   query tiles (the most key tiles) first, so the last blocks to start are
//   the light ones and the tail is short.  Tiles strictly above the
//   diagonal are skipped; only the diagonal tile is masked.
// - GQA reads KV head h / (Hq/Hkv) without materializing repeats; blocks of
//   one batch and neighbouring heads run together and share K and V in L2.
// - Sums are in a fixed order (each dot over d in order, each P v over keys
//   in order, the row reductions in a fixed shuffle order), so repeats give
//   the same bits.  S must be a multiple of 64 and D one of 32, 64, 128; the
//   wrapper checks both.
// Shared memory: q (64 x (D+4)), P (64 x 68) and two stages of K and V
// (2 x 64 x (D+4) each): 63 KB at D = 32, 104 KB at D = 64 (two blocks per
// SM), 186 KB at D = 128 (one).
// What bounds it in practice (tools/probe_kernels.py, PERF.md): copies
// without the FMAs of q k^T or of P v each save about a quarter of its time,
// so the FMAs run near the SIMT rate and the rest (shared loads, the
// softmax's exps, P through shared memory, barriers) costs about as much.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BKT = 64;      // keys per tile
constexpr int THREADS = 128; // 16 row groups x 8 key groups
constexpr int RI = 4;        // rows per thread: rg + 16 i
constexpr int KJ = BKT / 8;  // keys per thread in S: kg + 8 j
constexpr int LDP = BKT + 4; // P row stride (floats)
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(BQ == BKT, "causal tiles: only the diagonal key tile is masked");

template <int D>
struct Layout {
  static constexpr int LD = D + 4;                       // q, K, V row stride
  static constexpr int TILE = BKT * LD;                  // one K or V tile
  static constexpr int STAGE = 2 * TILE;                 // K and V
  static constexpr size_t BYTES = sizeof(float) * ((size_t)BQ * LD + (size_t)BQ * LDP +
                                                   2 * (size_t)STAGE);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// a += x . y over four consecutive d, in order.
__device__ __forceinline__ float dot4(float a, float4 x, float4 y) {
  a = fmaf(x.x, y.x, a);
  a = fmaf(x.y, y.y, a);
  a = fmaf(x.z, y.z, a);
  return fmaf(x.w, y.w, a);
}

// Max and sum over the 8 lanes of a row group (lanes 8r .. 8r+7).
__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 2));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 4));
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v + __shfl_xor_sync(FULL, v, 4);
}

template <int D>
__global__ void __launch_bounds__(THREADS, (D <= 64 ? 2 : 1))
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int B, int Hq, int Hkv,
                 int S, float scale, int causal) {
  using L = Layout<D>;
  constexpr int LD = L::LD;
  constexpr int NC = D / 32;                // float4 output columns per thread
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                           // [BQ][LD]
  float* ps = qs + BQ * LD;                 // [BQ][LDP]: P of the current tile
  float* ring = ps + BQ * LDP;              // 2 x ([BKT][LD] of k, [BKT][LD] of v)

  // Heaviest query tiles first (causal): tile index runs down the grid.
  const int nqt = S / BQ;
  const int nbh = Hq * B;
  const int qt_rank = blockIdx.x / nbh;
  const int qt = causal ? nqt - 1 - qt_rank : qt_rank;
  const int bh = blockIdx.x % nbh;
  const int h = bh % Hq, b = bh / Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = 4 * warp + (lane >> 3);    // row group: rows rg + 16 i
  const int kg = lane & 7;                  // key group: keys kg + 8 j, columns 4 kg + 32 c
  const size_t qbase = (((size_t)b * Hq + h) * S + (size_t)qt * BQ) * D;
  const size_t kvbase = ((size_t)b * Hkv + hk) * (size_t)S * D;
  const int nkt = causal ? qt + 1 : S / BKT;

  auto load_kv = [&](int kt) {
    float* ks = ring + (kt & 1) * L::STAGE;
    float* vs = ks + L::TILE;
    const float* kt_src = k + kvbase + (size_t)kt * BKT * D;
    const float* vt_src = v + kvbase + (size_t)kt * BKT * D;
    for (int i = tid; i < BKT * D / 4; i += THREADS) {
      const int r = i / (D / 4), c = 4 * (i % (D / 4));
      cp_async16(ks + r * LD + c, kt_src + (size_t)r * D + c);
      cp_async16(vs + r * LD + c, vt_src + (size_t)r * D + c);
    }
  };

  for (int i = tid; i < BQ * D / 4; i += THREADS) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4));
    cp_async16(qs + r * LD + c, q + qbase + (size_t)r * D + c);
  }
  load_kv(0);
  cp_async_commit();

  float4 acc[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait_all();
    __syncthreads();   // tile kt (and q) visible; tile kt-1's stage is free
    if (kt + 1 < nkt) load_kv(kt + 1);
    cp_async_commit();
    const float* ks = ring + (kt & 1) * L::STAGE;
    const float* vs = ks + L::TILE;

    // S = q k^T: rows rg + 16 i, keys kg + 8 j, each dot over d in order.
    float s[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RI], kv[KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = lds4(qs + (rg + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < KJ; ++j) kv[j] = lds4(ks + (kg + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = dot4(s[i][j], qv[i], kv[j]);
    }

    // Scale, mask the diagonal tile, and the online softmax of each row.
    const bool diag = causal && kt == qt;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = qt * BQ + rg + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        float x = s[i][j] * scale;
        if (diag && kt * BKT + kg + 8 * j > qpos) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float mn = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float pv = expf(s[i][j] - mn);
        sum += pv;
        ps[(rg + 16 * i) * LDP + kg + 8 * j] = pv;
      }
      l[i] = l[i] * alpha + group_sum(sum);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
    }
    __syncwarp();      // the warp's P rows written (only this warp reads them)

    // o += P v: rows rg + 16 i, columns 4 kg + 32 c, keys in order.
#pragma unroll 2
    for (int j0 = 0; j0 < BKT; j0 += 4) {
      float4 pr[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pr[i] = lds4(ps + (rg + 16 * i) * LDP + j0);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float4 vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = lds4(vs + (j0 + t) * LD + 4 * kg + 32 * c);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float pw = t == 0 ? pr[i].x : t == 1 ? pr[i].y : t == 2 ? pr[i].z : pr[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc[i][c].x = fmaf(pw, vv[c].x, acc[i][c].x);
            acc[i][c].y = fmaf(pw, vv[c].y, acc[i][c].y);
            acc[i][c].z = fmaf(pw, vv[c].z, acc[i][c].z);
            acc[i][c].w = fmaf(pw, vv[c].w, acc[i][c].w);
          }
        }
      }
    }
    __syncwarp();      // P read before the next tile overwrites it
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + qbase + (size_t)(rg + 16 * i) * D + 4 * kg;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(orow + 32 * c) =
          make_float4(acc[i][c].x / den, acc[i][c].y / den, acc[i][c].z / den,
                      acc[i][c].w / den);
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

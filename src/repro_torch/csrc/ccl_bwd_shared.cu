// Weighted analytic CCL backward (paper Eq. 4/5) for the step-shared
// negative layout (the LM HEAT head), from the cached statistics.
//
// Replaces the TPU kernel src/repro/kernels/ccl_similarity.py::
// ccl_bwd_shared_pallas (body _bwd_shared_kernel).  From u, p (T, K), the
// shared negatives (n, K), the statistics of ccl_stats_shared.cu, the row
// weights w (T, 1) and the scalar cotangent g (read from device memory, so
// the host never waits for it) it writes, per row t,
//     du_t = inv_u*(d_ps*p_hat - coeff*u_hat) + inv_u * sum_j wn_tj*n_j
//     dp_t = (d_ps*inv_p)*(u_hat - pos_sim*p_hat)
// and, summed over all T rows,
//     dn_j = sum_t wn_tj*u_hat_t - (sum_t wn_tj*neg_sim_tj) * inv_nn_j * n_j
// with d_ps = -g*w_t, d_ns = g*mu/n * w_t * [neg_sim > theta],
// wn = d_ns*inv_nn and coeff = d_ps*pos_sim + sum_j d_ns*neg_sim.  No dot
// product is recomputed.  A row with w = 0 contributes exactly zero.
//
// Bound on an H100 (3.35 TB/s): bytes.  At T = 8,184, K = 960, n = 64 it
// must read u and p and write du and dp (125.7 MB, plus 2.4 MB of stats and
// the negatives), about 38 us; the two (T,n)x(n,K)-sized contractions are
// 2.0 GFLOP, about 30 us on the fp64 tensor cores (67 TFLOP/s).
//
// The TPU kernel sums dn by revisiting one output block on a sequential
// grid.  CUDA blocks run in no order, and atomics would add in a run-to-run
// order, so there is no atomicAdd anywhere and every sum has a fixed order.
// dn's two sums run over all T rows and nearly cancel each other (both
// follow the negatives' direction), so they are accumulated in fp64 and dn
// is rounded to fp32 once; in fp32 the result would be off by about 1e-6.
// Inverse norms are rsqrtf, as PyTorch's rsqrt on the card.  Three passes:
//   1. scalars_kernel, one block per 32-row chunk: each row's scalars
//      (inv_u, inv_p, d_ps, pos_sim, coeff) and wn (T x n, as fp64, padded
//      with zeros to n16 = n rounded up to 16), written once to scratch,
//      where the next pass reads them from L2; and the chunk's column sums
//      sum_t wn*neg_sim in fp64 (warps' partials in order).
//   2. tile_kernel, a grid of K tiles (BK = 64 columns, 32 when n > 64) x
//      row slabs (whole chunks; as many slabs as give each SM one block):
//      a block holds only negs[:, tile] (as fp64, transposed, converted
//      once) and walks its slab's chunks.  Per chunk it computes on the
//      fp64 tensor cores (mma.sync m16n8k16, sm_90) wn @ negs[:, tile] for
//      du and adds wn^T @ u_hat to the slab's dn partial, held in registers
//      across the chunks; then stages du and dp in shared memory and writes
//      them as whole rows.  The chunk's wn and row scalars arrive through a
//      two-stage cp.async ring, and its u (for u_hat, converted to fp64 once
//      and staged transposed) is loaded into registers a chunk ahead, so the
//      loads overlap the MMAs.  The partials are slabs x n x K fp64 (7.9 MB
//      at the slice's shape), written as whole rows at the end.
//   3. reduce_kernel: dn_jk sums the slabs' partials in order and subtracts
//      (sum of the chunks' column sums, in order) * inv_nn_j * n_jk.
// Fragments: a lane's four k slots of an m16n8k16 are given four
// consecutive k, so fragment rows of wn (for du), of the transposed
// negatives and of the transposed u_hat are two 16-byte shared loads each;
// row strides of n16 + 2 and 34 doubles keep those free of bank conflicts
// at n = 64 (wn^T's fragments for dn are eight 8-byte loads, two-way
// conflicted).
// Shared memory: at n = 64 (BK = 64) 34 KB of negatives, 17 KB of u_hat,
// 36 KB of ring and 17 KB of du / dp staging; at n = 192 (BK = 32) 168 KB.
// One block of 8 warps per SM: the fp64 fragments take about 190 registers
// a thread, and a cap of 128 (two blocks) spilled and ran slower.
// What bounds it in practice (tools/probe_kernels.py, PERF.md): not one
// resource.  A copy without its loads and one without its MMAs each take
// about two thirds of its time, and one without either (the three passes'
// skeleton: barriers, u_hat staging, the epilogue and its stores) a third:
// the loads and the MMAs each cost more than their bound, and overlap only
// in part, because one block of 8 warps per SM runs each chunk's phases
// between two barriers.
// tools/probe_kernels.py times this kernel against copies of itself built
// with -DPROBE_NO_LOADS (no loads of u, p and the ring; the results are
// garbage) and -DPROBE_NO_COMPUTE (no MMAs); neither is defined otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;                 // rows per chunk
constexpr int THREADS = 256;           // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RS = 8;                  // floats of row scalars per row (5 used)
constexpr int LDU = BM + 2;            // row stride (doubles) of the transposed u_hat
constexpr int LDO_PAD = 4;             // du / dp staging row stride: BK + 4 floats
constexpr int MAX_N = 192;             // most negatives (scalars_kernel's colw)
constexpr float EPS = 1e-12f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Pass 1: the rows' scalars and wn of one 32-row chunk; warp w takes rows
// 4w .. 4w+3, lane l the negatives j = l mod 32.
__global__ void __launch_bounds__(THREADS)
scalars_kernel(const float* __restrict__ uu, const float* __restrict__ pp,
               const float* __restrict__ up, const float* __restrict__ nn,
               const float* __restrict__ un, const float* __restrict__ w,
               const float* __restrict__ g_ptr, float* __restrict__ rs,
               double* __restrict__ wn64, double* __restrict__ colpart, int T, int n,
               int n16, float mu, float theta, float inv_n_negs) {
  __shared__ double colw[WARPS][MAX_N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float g = *g_ptr;
  const float dns_scale = g * mu * inv_n_negs;
  for (int j = lane; j < n; j += 32) colw[warp][j] = 0.0;
  for (int rr = 0; rr < BM / WARPS; ++rr) {
    const int gr = blockIdx.x * BM + warp * (BM / WARPS) + rr;
    if (gr >= T) break;
    const float inv_u = rsqrtf(uu[gr] + EPS);
    const float inv_p = rsqrtf(pp[gr] + EPS);
    const float pos_sim = up[gr] * inv_u * inv_p;
    const float wr = w[gr];
    const float d_ps = -g * wr;
    float s_dns = 0.f;
    for (int j = lane; j < n16; j += 32) {
      float wv = 0.f;
      if (j < n) {
        const float inv_nn = rsqrtf(nn[j] + EPS);
        const float neg_sim = un[(size_t)gr * n + j] * inv_u * inv_nn;
        const float d_ns = dns_scale * wr * (neg_sim > theta ? 1.f : 0.f);
        wv = d_ns * inv_nn;
        s_dns += d_ns * neg_sim;
        colw[warp][j] += (double)wv * (double)neg_sim;
      }
      wn64[(size_t)gr * n16 + j] = wv;
    }
    s_dns = warp_sum(s_dns);
    if (lane == 0) {
      float* r = rs + (size_t)gr * RS;
      r[0] = inv_u;
      r[1] = inv_p;
      r[2] = d_ps;
      r[3] = pos_sim;
      r[4] = d_ps * pos_sim + s_dns;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += THREADS) {
    double s = 0.0;
    for (int q = 0; q < WARPS; ++q) s += colw[q][j];
    colpart[(size_t)blockIdx.x * n + j] = s;
  }
}

// cp.async of 16 bytes; ok = false zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// D (16x8) += A (16x16, row) * B (16x8, col) in fp64 (sm_90).  Fragments
// (g = lane / 4, q = lane % 4): a[i] = A[g + 8*(i%2)][k(i/2)], b[j] =
// B[k(j)][g], d = {D[g][2q], D[g][2q+1], D[g+8][2q], D[g+8][2q+1]}, where
// this kernel names lane q's four k slots k(s) = 4q + s (see the header).
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[8],
                                        const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Four consecutive doubles of shared memory (16-byte aligned) into b.
__device__ __forceinline__ void load4(double (&b)[4], const double* s) {
  const double2 x = *reinterpret_cast<const double2*>(s);
  const double2 y = *reinterpret_cast<const double2*>(s + 2);
  b[0] = x.x;
  b[1] = x.y;
  b[2] = y.x;
  b[3] = y.y;
}

template <int BK>
struct Tile;

// u of chunk rows [r0, r0 + BM) x tile columns into registers (0 outside
// the slab and past K): thread tid holds elements tid + THREADS * e.
template <int BK, int UPT>
__device__ __forceinline__ void load_u(float (&ureg)[UPT], const float* __restrict__ u,
                                       int r0, int row_end, int col0, int K) {
#ifndef PROBE_NO_LOADS
#pragma unroll
  for (int e = 0; e < UPT; ++e) {
    const int idx = threadIdx.x + THREADS * e, r = idx / BK, c = idx % BK;
    const bool ok = r0 + r < row_end && col0 + c < K;
    ureg[e] = ok ? u[(size_t)(r0 + r) * K + col0 + c] : 0.f;
  }
#endif
}

// Rows [r0, r0 + BM) x tile columns of a (T, K) output from a staged
// [BM][BK + LDO_PAD] tile: each row's columns as 16-byte stores where K
// allows, rows past row_end and columns past K skipped.
template <int BK>
__device__ __forceinline__ void store_rows(float* __restrict__ out, const float* tile, int r0,
                                           int row_end, int col0, int K) {
  const bool vec = (K & 3) == 0;
  for (int i = threadIdx.x; i < BM * (BK / 4); i += THREADS) {
    const int r = i / (BK / 4), c = 4 * (i % (BK / 4));
    if (r0 + r >= row_end) continue;
    const float* src = tile + r * (BK + LDO_PAD) + c;
    float* dst = out + (size_t)(r0 + r) * K + col0 + c;
    if (vec && col0 + c + 3 < K) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col0 + c + j < K) dst[j] = src[j];
    }
  }
}

template <int BK>
struct Tile {
  static constexpr int DU_NT = BK / 32;       // du: n tiles of 8 columns per warp
  static constexpr int CG = BK / 32;          // dn: column groups of 32 per negative tile
  static constexpr int IPW = BK == 64 ? 1 : 2;  // dn items per warp (n16 <= 64 / <= 192)
  static constexpr int UPT = BM * BK / THREADS; // u (and u_hat) elements per thread
};

// Shared memory of tile_kernel<BK> (bytes) for n16 = n rounded up to 16.
template <int BK>
size_t tile_smem(int n16) {
  const size_t ld = (size_t)n16 + 2;
  return sizeof(double) * ((size_t)BK * ld + (size_t)BK * LDU + 2 * ((size_t)BM * ld + BM * RS / 2)) +
         sizeof(float) * 2 * BM * (BK + LDO_PAD);
}

// Pass 2: du, dp of a K tile for a slab of rows, and the slab's dn partial.
// One block per SM: a cap of two (128 registers) spilled and ran slower.
template <int BK>
__global__ void __launch_bounds__(THREADS, 1)
tile_kernel(const float* __restrict__ u, const float* __restrict__ p,
            const float* __restrict__ negs, const float* __restrict__ rs,
            const double* __restrict__ wn64, float* __restrict__ du, float* __restrict__ dp,
            double* __restrict__ part, int T, int n, int n16, int K, int rows_per_slab) {
  using C = Tile<BK>;
  extern __shared__ __align__(16) double smd[];
  const int ld = n16 + 2;                    // LDN = LDW
  double* negT = smd;                        // [BK][ld]: negs[:, tile] transposed
  double* uhT = negT + BK * ld;              // [BK][LDU]: the chunk's u_hat transposed
  double* ring = uhT + BK * LDU;             // 2 x ([BM][ld] of wn, [BM][RS] floats of scalars)
  const int stage_d = BM * ld + BM * RS / 2;
  constexpr int LDO = BK + LDO_PAD;
  float* du_s = reinterpret_cast<float*>(ring + 2 * stage_d);   // [BM][LDO]: the chunk's du
  float* dp_s = du_s + BM * LDO;                                // [BM][LDO]: its dp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int col0 = blockIdx.x * BK;
  const int row_begin = blockIdx.y * rows_per_slab;
  const int row_end = min(T, row_begin + rows_per_slab);
  const int chunks = (row_end - row_begin + BM - 1) / BM;
  const int nks = n16 / 16;

  for (int i = tid; i < n16 * BK; i += THREADS) {
    const int j = i / BK, c = i % BK;
    const bool ok = j < n && col0 + c < K;
    negT[c * ld + j] = ok ? (double)negs[(size_t)j * K + col0 + c] : 0.0;
  }

  auto stage = [&](int ch) -> double* { return ring + (ch & 1) * stage_d; };
  auto issue = [&](int ch) {
#ifndef PROBE_NO_LOADS
    double* wn_s = stage(ch);
    float* rs_s = reinterpret_cast<float*>(wn_s + BM * ld);
    const int r0 = row_begin + ch * BM;
    const int pieces = n16 / 2;
    for (int i = tid; i < BM * pieces; i += THREADS) {
      const int r = i / pieces, pc = i % pieces;
      const bool ok = r0 + r < row_end;
      cp_async16(wn_s + r * ld + 2 * pc, ok ? wn64 + (size_t)(r0 + r) * n16 + 2 * pc : wn64, ok);
    }
    for (int i = tid; i < BM * 2; i += THREADS) {
      const int r = i / 2, h = i % 2;
      const bool ok = r0 + r < row_end;
      cp_async16(rs_s + r * RS + 4 * h, ok ? rs + (size_t)(r0 + r) * RS + 4 * h : rs, ok);
    }
#endif
  };
  float ureg[C::UPT];
  // This warp's du item: row tile mi, column tiles nt0 .. nt0 + DU_NT - 1.
  const int mi = warp & 1;
  const int nt0 = (warp >> 1) * C::DU_NT;
  // This warp's dn items: negative tile mt, column group cg, as sums in fp64.
  double dnacc[C::IPW][4][4];
#pragma unroll
  for (int ii = 0; ii < C::IPW; ++ii)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dnacc[ii][t][e] = 0.0;

  if (chunks > 0) {
    issue(0);
    load_u<BK>(ureg, u, row_begin, row_end, col0, K);
  }
  cp_async_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait_all();
    __syncthreads();   // chunk ch's ring stage visible; u_hat and stage ch-1 free
    if (ch + 1 < chunks) issue(ch + 1);
    cp_async_commit();
    const double* wn_s = stage(ch);
    const float* rs_s = reinterpret_cast<const float*>(wn_s + BM * ld);
    const int r0 = row_begin + ch * BM;

    // u_hat = u * inv_u (fp32, as the plain version), staged transposed in fp64.
#pragma unroll
    for (int e = 0; e < C::UPT; ++e) {
      const int idx = tid + THREADS * e, r = idx / BK, c = idx % BK;
      uhT[c * LDU + r] = (double)(ureg[e] * rs_s[r * RS]);
    }
    if (ch + 1 < chunks) load_u<BK>(ureg, u, r0 + BM, row_end, col0, K);
    float preg[C::DU_NT][4];   // p at this thread's du positions, for the epilogue
#ifndef PROBE_NO_LOADS
#pragma unroll
    for (int t = 0; t < C::DU_NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * mi + g + 8 * (e >> 1), c = 8 * (nt0 + t) + 2 * q + (e & 1);
        const bool ok = r0 + r < row_end && col0 + c < K;
        preg[t][e] = ok ? p[(size_t)(r0 + r) * K + col0 + c] : 0.f;
      }
#endif
    __syncthreads();   // u_hat visible

    double duacc[C::DU_NT][4];
#pragma unroll
    for (int t = 0; t < C::DU_NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) duacc[t][e] = 0.0;
#ifndef PROBE_NO_COMPUTE
    {
      // du: wn (rows 16mi.., k = negatives) @ negs^T tile (k = negatives).
      for (int ks = 0; ks < nks; ++ks) {
        double a[8], lo[4], hi[4];
        load4(lo, wn_s + (16 * mi + g) * ld + 16 * ks + 4 * q);
        load4(hi, wn_s + (16 * mi + g + 8) * ld + 16 * ks + 4 * q);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          a[2 * s] = lo[s];
          a[2 * s + 1] = hi[s];
        }
#pragma unroll
        for (int t = 0; t < C::DU_NT; ++t) {
          double b[4];
          load4(b, negT + (8 * (nt0 + t) + g) * ld + 16 * ks + 4 * q);
          mma_f64(duacc[t], a, b);
        }
      }
      // dn partial: wn^T (negatives, k = rows) @ u_hat (k = rows).
#pragma unroll
      for (int ii = 0; ii < C::IPW; ++ii) {
        const int item = warp + WARPS * ii;
        const int mt = item / C::CG, cg = item % C::CG;
        if (mt < nks) {
#pragma unroll
          for (int ks = 0; ks < BM / 16; ++ks) {
            double a[8];
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              const double* row = wn_s + (16 * ks + 4 * q + s) * ld + 16 * mt + g;
              a[2 * s] = row[0];
              a[2 * s + 1] = row[8];
            }
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              double b[4];
              load4(b, uhT + (32 * cg + 8 * t + g) * LDU + 16 * ks + 4 * q);
              mma_f64(dnacc[ii][t], a, b);
            }
          }
        }
      }
    }
#endif

    // du and dp of this warp's du positions, staged in shared memory: the
    // fragments' scattered 8-byte pieces of rows would reach device memory as
    // partial sectors, which measured several times slower than whole rows.
#pragma unroll
    for (int t = 0; t < C::DU_NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * mi + g + 8 * (e >> 1), c = 8 * (nt0 + t) + 2 * q + (e & 1);
        const float* sc = rs_s + r * RS;
        const float inv_u = sc[0], inv_p = sc[1], d_ps = sc[2], pos_sim = sc[3],
                    coeff = sc[4];
        const float uhat = (float)uhT[c * LDU + r];
        const float phat = preg[t][e] * inv_p;
        du_s[r * LDO + c] = inv_u * (d_ps * phat - coeff * uhat) + inv_u * (float)duacc[t][e];
        dp_s[r * LDO + c] = (d_ps * inv_p) * (uhat - pos_sim * phat);
      }
    __syncthreads();   // the chunk's du and dp staged
    store_rows<BK>(du, du_s, r0, row_end, col0, K);
    store_rows<BK>(dp, dp_s, r0, row_end, col0, K);
  }
  cp_async_wait_all();
  __syncthreads();     // the ring is free: it stages the dn partial now

  // The slab's dn partial, part[slab][j][k], staged as [n16][BK + 2] doubles
  // and written as whole rows.
  double* dn_s = ring;
  const int ldd = BK + 2;
#pragma unroll
  for (int ii = 0; ii < C::IPW; ++ii) {
    const int item = warp + WARPS * ii;
    const int mt = item / C::CG, cg = item % C::CG;
    if (mt >= nks) continue;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dn_s[(16 * mt + g + 8 * (e >> 1)) * ldd + 32 * cg + 8 * t + 2 * q + (e & 1)] =
            dnacc[ii][t][e];
  }
  __syncthreads();
  const bool vec = (K & 1) == 0;
  for (int i = tid; i < n * (BK / 2); i += THREADS) {
    const int j = i / (BK / 2), c = 2 * (i % (BK / 2));
    double* dst = part + ((size_t)blockIdx.y * n + j) * K + col0 + c;
    const double* src = dn_s + j * ldd + c;
    if (vec && col0 + c + 1 < K) {
      *reinterpret_cast<double2*>(dst) = make_double2(src[0], src[1]);
    } else {
      if (col0 + c < K) dst[0] = src[0];
      if (col0 + c + 1 < K) dst[1] = src[1];
    }
  }
}

// Pass 3: dn_jk = sum over slabs of part (in order) - col_j * inv_nn_j * n_jk,
// col_j the chunks' column sums (each thread's strided run in order, then
// the block's threads in order).
__global__ void __launch_bounds__(128)
reduce_kernel(const double* __restrict__ part, const double* __restrict__ colpart,
              const float* __restrict__ nn, const float* __restrict__ negs,
              float* __restrict__ dn, int slabs, int nchunks, int n, int K) {
  __shared__ double cs[128];
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  double c = 0.0;
  for (int ch = tid; ch < nchunks; ch += 128) c += colpart[(size_t)ch * n + j];
  cs[tid] = c;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int i = 0; i < 128; ++i) s += cs[i];
    cs[0] = s;
  }
  __syncthreads();
  const double col = cs[0];
  const int k = blockIdx.x * 128 + tid;
  if (k >= K) return;
  double s = 0.0;
  for (int sl = 0; sl < slabs; ++sl) s += part[((size_t)sl * n + j) * K + k];
  const double inv_nn = rsqrtf(nn[j] + EPS);
  dn[(size_t)j * K + k] = (float)(s - (col * inv_nn) * (double)negs[(size_t)j * K + k]);
}

struct Plan {
  int bk, n16, nchunks, ktiles, rows_per_slab, slabs;
  size_t rs_bytes, wn_bytes, col_bytes, part_bytes;
};

// The grid and scratch layout for (T, n, K) on the current device: K tiles
// of bk columns x slabs of whole 32-row chunks, as many slabs as give one
// block to each SM (one fits; one wave measured faster than two).
Plan make_plan(int T, int n, int K) {
  Plan pl;
  pl.n16 = (n + 15) / 16 * 16;
  pl.bk = pl.n16 <= 64 ? 64 : 32;
  pl.nchunks = (T + BM - 1) / BM;
  pl.ktiles = (K + pl.bk - 1) / pl.bk;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  int target = sms / (pl.ktiles > 0 ? pl.ktiles : 1);
  if (target < 1) target = 1;
  const int per_slab = pl.nchunks > 0 ? (pl.nchunks + target - 1) / target : 1;
  pl.rows_per_slab = per_slab * BM;
  pl.slabs = pl.nchunks > 0 ? (pl.nchunks + per_slab - 1) / per_slab : 0;
  auto up256 = [](size_t b) { return (b + 255) / 256 * 256; };
  pl.rs_bytes = up256(sizeof(float) * RS * (size_t)T);
  pl.wn_bytes = up256(sizeof(double) * (size_t)pl.n16 * T);
  pl.col_bytes = up256(sizeof(double) * (size_t)pl.nchunks * n);
  pl.part_bytes = up256(sizeof(double) * (size_t)pl.slabs * n * K);
  return pl;
}

template <int BK>
int launch_tiles(const Plan& pl, const float* u, const float* p, const float* negs,
                 const float* rs, const double* wn64, float* du, float* dp, double* part,
                 int T, int n, int K, cudaStream_t s) {
  const size_t smem = tile_smem<BK>(pl.n16);
  const cudaError_t e = cudaFuncSetAttribute(
      tile_kernel<BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(pl.ktiles, pl.slabs);
  tile_kernel<BK><<<grid, THREADS, smem, s>>>(u, p, negs, rs, wn64, du, dp, part, T, n,
                                               pl.n16, K, pl.rows_per_slab);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of scratch the wrapper allocates for ccl_bwd_shared at (T, n, K).
extern "C" size_t ccl_bwd_shared_scratch_bytes(int T, int n, int K) {
  const Plan pl = make_plan(T, n, K);
  return pl.rs_bytes + pl.wn_bytes + pl.col_bytes + pl.part_bytes;
}

extern "C" int ccl_bwd_shared(const void* u, const void* p, const void* negs, const void* uu,
                              const void* pp, const void* up, const void* nn, const void* un,
                              const void* w, const void* g, void* du, void* dp, void* dn,
                              void* scratch, int T, int n, int K, float mu, float theta,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || K <= 0) return 0;
  if (n > MAX_N) return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(T, n, K);
  char* base = (char*)scratch;
  float* rs = (float*)base;
  double* wn64 = (double*)(base + pl.rs_bytes);
  double* colpart = (double*)(base + pl.rs_bytes + pl.wn_bytes);
  double* part = (double*)(base + pl.rs_bytes + pl.wn_bytes + pl.col_bytes);
  if (pl.nchunks > 0) {
    scalars_kernel<<<pl.nchunks, THREADS, 0, s>>>(
        (const float*)uu, (const float*)pp, (const float*)up, (const float*)nn,
        (const float*)un, (const float*)w, (const float*)g, rs, wn64, colpart, T, n, pl.n16,
        mu, theta, 1.0f / (float)n);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int err = pl.bk == 64
        ? launch_tiles<64>(pl, (const float*)u, (const float*)p, (const float*)negs, rs, wn64,
                           (float*)du, (float*)dp, part, T, n, K, s)
        : launch_tiles<32>(pl, (const float*)u, (const float*)p, (const float*)negs, rs, wn64,
                           (float*)du, (float*)dp, part, T, n, K, s);
    if (err != 0) return err;
  }
  const dim3 grid((K + 127) / 128, n);
  reduce_kernel<<<grid, 128, 0, s>>>(part, colpart, (const float*)nn, (const float*)negs,
                                     (float*)dn, pl.slabs, pl.nchunks, n, K);
  return (int)cudaGetLastError();
}

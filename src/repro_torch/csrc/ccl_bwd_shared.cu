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
// 2.0 GFLOP, about 30 us at the fp32 peak.
//
// The TPU kernel sums dn by revisiting one output block on a sequential
// grid.  CUDA blocks run in no order, and atomics would add in a run-to-run
// order, so the sum is split in two fixed-order passes and there is no
// atomicAdd anywhere:
//   1. rows_kernel: one block per 64 rows.  It forms the rows' scalars and
//      wn (64 x n) in shared memory, then walks K in chunks of 32, staging
//      the negatives and u_hat: each thread writes du, dp for one column of
//      8 rows (8 independent sums over j in order, for instruction-level
//      parallelism) and the block's partial of dn for one column of n/8
//      negatives (independent sums over its 64 rows in order) into
//      part[block] (blocks x n x K), and the block's column sums
//      sum_t wn*neg_sim into colpart[block] (warps' partials in order).
//   2. reduce_kernel: dn_j,k sums part[b][j][k] over the blocks in order,
//      and subtracts (sum_b colpart[b][j]) * inv_nn_j * n_jk.
// dn's two sums run over all T rows and nearly cancel each other (both
// follow the negatives' direction), so they are accumulated in fp64 (the
// partials too: 63 MB at the slice's shape) and dn is rounded to fp32 once;
// in fp32 the result would be off by about 1e-6.  Inverse norms are rsqrtf,
// as PyTorch's rsqrt on the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows per block
constexpr int KC = 32;        // K per staged chunk
constexpr int THREADS = 256;  // 8 warps, 8 rows each
constexpr int WARPS = THREADS / 32;
constexpr float EPS = 1e-12f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
rows_kernel(const float* __restrict__ u, const float* __restrict__ p,
            const float* __restrict__ negs, const float* __restrict__ uu,
            const float* __restrict__ pp, const float* __restrict__ up,
            const float* __restrict__ nn, const float* __restrict__ un,
            const float* __restrict__ w, const float* __restrict__ g_ptr,
            float* __restrict__ du, float* __restrict__ dp, double* __restrict__ part,
            double* __restrict__ colpart, int T, int n, int K, float mu, float theta,
            float inv_n_negs) {
  extern __shared__ __align__(16) double shd[];
  double* colw = shd;                // [WARPS][n], per-warp column partials
  double* wnd = colw + WARPS * n;    // [BM][n], wn in fp64 (for dn)
  double* uhd = wnd + BM * n;        // [BM][KC], u_hat in fp64 (for dn)
  float* wn = reinterpret_cast<float*>(uhd + BM * KC);   // [BM][n] (for du)
  float* nchunk = wn + BM * n;       // [n][KC]
  float* rs = nchunk + n * KC;       // [5][BM]: inv_u, inv_p, d_ps, pos_sim, coeff
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * BM;
  const float g = *g_ptr;
  const float dns_scale = g * mu * inv_n_negs;

  // Rows' scalars and wn: warp w takes rows 8w .. 8w+7, lane l the
  // negatives j = l mod 32.
  for (int j = lane; j < n; j += 32) colw[warp * n + j] = 0.0;
  for (int rr = 0; rr < 8; ++rr) {
    const int r = warp * 8 + rr;
    const int gr = row0 + r;
    const bool live = gr < T;
    float inv_u = 0.f, inv_p = 0.f, d_ps = 0.f, pos_sim = 0.f, wr = 0.f;
    if (live) {
      inv_u = rsqrtf(uu[gr] + EPS);
      inv_p = rsqrtf(pp[gr] + EPS);
      pos_sim = up[gr] * inv_u * inv_p;
      wr = w[gr];
      d_ps = -g * wr;
    }
    float s_dns = 0.f;
    for (int j = lane; j < n; j += 32) {
      float wv = 0.f;
      if (live) {
        const float inv_nn = rsqrtf(nn[j] + EPS);
        const float neg_sim = un[(size_t)gr * n + j] * inv_u * inv_nn;
        const float d_ns = dns_scale * wr * (neg_sim > theta ? 1.f : 0.f);
        wv = d_ns * inv_nn;
        s_dns += d_ns * neg_sim;
        colw[warp * n + j] += (double)wv * (double)neg_sim;
      }
      wn[r * n + j] = wv;
      wnd[r * n + j] = wv;
    }
    s_dns = warp_sum(s_dns);
    if (lane == 0) {
      rs[r] = inv_u;
      rs[BM + r] = inv_p;
      rs[2 * BM + r] = d_ps;
      rs[3 * BM + r] = pos_sim;
      rs[4 * BM + r] = d_ps * pos_sim + s_dns;
    }
  }
  __syncthreads();
  for (int j = tid; j < n; j += THREADS) {
    double s = 0.0;
    for (int q = 0; q < WARPS; ++q) s += colw[q * n + j];
    colpart[(size_t)blockIdx.x * n + j] = s;
  }

  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int i = tid; i < n * KC; i += THREADS) {
      const int j = i / KC, gk = k0 + i % KC;
      nchunk[i] = gk < K ? negs[(size_t)j * K + gk] : 0.f;
    }
    for (int i = tid; i < BM * KC; i += THREADS) {
      const int r = i / KC, gr = row0 + r, gk = k0 + i % KC;
      uhd[i] = (gr < T && gk < K) ? u[(size_t)gr * K + gk] * rs[r] : 0.f;
    }
    __syncthreads();
    const int gk = k0 + lane;
    if (gk < K) {
      // du, dp: this thread's column, the warp's 8 rows as 8 independent
      // sums over j in order.
      float acc[8];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) acc[rr] = 0.f;
      for (int j = 0; j < n; ++j) {
        const float x = nchunk[j * KC + lane];
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) acc[rr] = fmaf(wn[(warp * 8 + rr) * n + j], x, acc[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const int r = warp * 8 + rr;
        const int gr = row0 + r;
        if (gr < T) {
          const float inv_u = rs[r], inv_p = rs[BM + r], d_ps = rs[2 * BM + r];
          const float pos_sim = rs[3 * BM + r], coeff = rs[4 * BM + r];
          const float uhat = (float)uhd[r * KC + lane];
          const float phat = p[(size_t)gr * K + gk] * inv_p;
          du[(size_t)gr * K + gk] = inv_u * (d_ps * phat - coeff * uhat) + inv_u * acc[rr];
          dp[(size_t)gr * K + gk] = (d_ps * inv_p) * (uhat - pos_sim * phat);
        }
      }
      // This block's partial of dn: this thread's column, the negatives
      // j = warp mod 8 as independent sums over the block's rows in order.
      for (int j0 = warp; j0 < n; j0 += 8 * WARPS) {
        double pacc[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) pacc[jj] = 0.0;
        for (int r = 0; r < BM; ++r) {
          const double x = uhd[r * KC + lane];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = j0 + WARPS * jj;
            if (j < n) pacc[jj] = fma(wnd[r * n + j], x, pacc[jj]);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = j0 + WARPS * jj;
          if (j < n) part[((size_t)blockIdx.x * n + j) * K + gk] = pacc[jj];
        }
      }
    }
    __syncthreads();
  }
}

__global__ void reduce_kernel(const double* __restrict__ part,
                              const double* __restrict__ colpart,
                              const float* __restrict__ nn, const float* __restrict__ negs,
                              float* __restrict__ dn, int nblocks, int n, int K) {
  const int j = blockIdx.y;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  double col = 0.0;
#pragma unroll 8
  for (int b = 0; b < nblocks; ++b) col += colpart[(size_t)b * n + j];
  double s = 0.0;
#pragma unroll 8
  for (int b = 0; b < nblocks; ++b) s += part[((size_t)b * n + j) * K + k];
  const double inv_nn = rsqrtf(nn[j] + EPS);
  dn[(size_t)j * K + k] = (float)(s - (col * inv_nn) * (double)negs[(size_t)j * K + k]);
}

// Shared memory of rows_kernel for n negatives (bytes).
size_t rows_smem(int n) {
  return sizeof(double) * ((size_t)WARPS * n + (size_t)BM * n + (size_t)BM * KC) +
         sizeof(float) * ((size_t)BM * n + (size_t)n * KC + 5 * BM);
}

}  // namespace

// Rows per block of rows_kernel: part and colpart hold ceil(T / rows) blocks.
extern "C" int ccl_bwd_shared_rows_per_block() { return BM; }

extern "C" int ccl_bwd_shared(const void* u, const void* p, const void* negs, const void* uu,
                              const void* pp, const void* up, const void* nn, const void* un,
                              const void* w, const void* g, void* du, void* dp, void* dn,
                              void* part, void* colpart, int T, int n, int K, float mu,
                              float theta, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || K <= 0) return 0;
  const int nblocks = (T + BM - 1) / BM;
  if (nblocks > 0) {
    const size_t smem = rows_smem(n);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    rows_kernel<<<nblocks, THREADS, smem, s>>>(
        (const float*)u, (const float*)p, (const float*)negs, (const float*)uu,
        (const float*)pp, (const float*)up, (const float*)nn, (const float*)un,
        (const float*)w, (const float*)g, (float*)du, (float*)dp, (double*)part,
        (double*)colpart, T, n, K, mu, theta, 1.0f / (float)n);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((K + 127) / 128, n);
  reduce_kernel<<<grid, 128, 0, s>>>((const double*)part, (const double*)colpart,
                                     (const float*)nn, (const float*)negs, (float*)dn,
                                     nblocks, n, K);
  return (int)cudaGetLastError();
}

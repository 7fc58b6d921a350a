// Fused CCL similarity statistics for the step-shared negative layout (the LM
// HEAT head): T rows of user/positive embeddings against one set of n
// negatives shared by every row.
//
// Replaces the TPU kernel src/repro/kernels/ccl_similarity.py::
// ccl_stats_shared_pallas (body _stats_shared_kernel).  It writes
//     uu = |u_t|^2, pp = |p_t|^2, up = u_t.p_t                (T, 1) each
//     nn_j = |n_j|^2                                          (1, n), once
//     un_tj = u_t.n_j                                         (T, n)
// from fp32 inputs, as fp32.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores):
// bytes.  At the slice's T = 8*1023 = 8,184, K = 960, n = 64 the kernel must
// read u and p once (62.9 MB) and the negatives once (0.25 MB), about 19 us;
// un is a (T,K)x(K,n) product of 1.0 GFLOP, about 15 us at the fp32 peak.
// The TPU kernel keeps the whole (n, K) block in VMEM; here the 240 KB
// block does not fit a block's shared memory, so a block takes 64 rows and
// 64 negatives and walks K in chunks of 32: each chunk of u and of the
// negatives is staged in shared memory (k-major, converted to fp64 once) and
// every thread accumulates a 4x4 tile of un.  The negatives are read from L2 once per
// row block (128 blocks x 240 KB), u and p once from device memory.
//
// Accuracy and repeatability: every sum over K is accumulated in fp64 (the
// product of two fp32 values is exact in fp64) in a fixed order, and
// rounded to fp32 once.  An fp32 sum of K = 960 products whose partial sums
// are of order 1 is off by a few 1e-7, which is the whole tolerance of a
// near-zero dot product; in fp64 the result is the correctly rounded one in
// nearly every case, as the plain version's is, whatever the scale of the
// data.  The fp64 FMAs run at half the fp32 rate: about 30 us for un at the
// slice's shape.  un is a sequential sum over K per thread; uu, pp, up are
// lane partials (lane l takes k = l mod 32, in K order), then a shuffle
// butterfly, as in ccl_stats.cu.  nn is computed once, by its own small
// kernel (one warp per negative).  Rows past T and columns past n read zeros
// and are not written, so a ragged T needs no padding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // rows per block
constexpr int BN = 64;    // negatives per block
constexpr int BK = 32;    // K per staged chunk
constexpr int THREADS = 256;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// nn_j = |n_j|^2, one warp per negative.
__global__ void nn_kernel(const float* __restrict__ negs, float* __restrict__ nn, int n,
                          int K) {
  const int j = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= n) return;
  const float* row = negs + (size_t)j * K;
  double a = 0.0;
  for (int k = lane; k < K; k += 32) {
    const double x = row[k];
    a = fma(x, x, a);
  }
  a = warp_sum(a);
  if (lane == 0) nn[j] = (float)a;
}

__global__ void __launch_bounds__(THREADS)
stats_kernel(const float* __restrict__ u, const float* __restrict__ p,
             const float* __restrict__ negs, float* __restrict__ uu, float* __restrict__ pp,
             float* __restrict__ up, float* __restrict__ un, int T, int n, int K) {
  // Chunks staged in fp64 (each element converted once, not once per use).
  __shared__ __align__(16) double As[BK][BM + 2];  // u chunk, k-major
  __shared__ __align__(16) double Bs[BK][BN + 2];  // negatives chunk, k-major
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;       // output columns 4*tx .. 4*tx+3
  const int ty = tid >> 4;       // output rows 4*ty .. 4*ty+3
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const bool norms = blockIdx.y == 0;   // one block column writes uu, pp, up

  double acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;
  double nrm[8][3];              // warp's 8 rows: uu, pp, up lane partials
#pragma unroll
  for (int r = 0; r < 8; ++r) nrm[r][0] = nrm[r][1] = nrm[r][2] = 0.0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < T && gk < K) ? (double)u[(size_t)gr * K + gk] : 0.0;
    }
    for (int i = tid; i < BN * BK; i += THREADS) {
      const int c = i / BK, kk = i % BK;
      const int gc = col0 + c, gk = k0 + kk;
      Bs[kk][c] = (gc < n && gk < K) ? (double)negs[(size_t)gc * K + gk] : 0.0;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const double2 a01 = *reinterpret_cast<const double2*>(&As[kk][4 * ty]);
      const double2 a23 = *reinterpret_cast<const double2*>(&As[kk][4 * ty + 2]);
      const double2 b01 = *reinterpret_cast<const double2*>(&Bs[kk][4 * tx]);
      const double2 b23 = *reinterpret_cast<const double2*>(&Bs[kk][4 * tx + 2]);
      const double av[4] = {a01.x, a01.y, a23.x, a23.y};
      const double bv[4] = {b01.x, b01.y, b23.x, b23.y};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(av[i], bv[j], acc[i][j]);
    }

    if (norms) {
      const int gk = k0 + lane;
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const int r = warp * 8 + rr;
        const int gr = row0 + r;
        const double x = As[lane][r];
        const double y = (gr < T && gk < K) ? p[(size_t)gr * K + gk] : 0.f;
        nrm[rr][0] = fma(x, x, nrm[rr][0]);
        nrm[rr][1] = fma(y, y, nrm[rr][1]);
        nrm[rr][2] = fma(x, y, nrm[rr][2]);
      }
    }
    __syncthreads();
  }

  if (norms) {
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const double a = warp_sum(nrm[rr][0]);
      const double c = warp_sum(nrm[rr][1]);
      const double d = warp_sum(nrm[rr][2]);
      const int gr = row0 + warp * 8 + rr;
      if (lane == 0 && gr < T) {
        uu[gr] = (float)a;
        pp[gr] = (float)c;
        up[gr] = (float)d;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + 4 * ty + i;
    if (gr >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + 4 * tx + j;
      if (gc < n) un[(size_t)gr * n + gc] = (float)acc[i][j];
    }
  }
}

}  // namespace

extern "C" int ccl_stats_shared(const void* u, const void* p, const void* negs, void* uu,
                                void* pp, void* up, void* nn, void* un, int T, int n, int K,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) nn_kernel<<<(n + 7) / 8, 256, 0, s>>>((const float*)negs, (float*)nn, n, K);
  if (T > 0) {
    const dim3 grid((T + BM - 1) / BM, n > 0 ? (n + BN - 1) / BN : 1);
    stats_kernel<<<grid, THREADS, 0, s>>>((const float*)u, (const float*)p,
                                          (const float*)negs, (float*)uu, (float*)pp,
                                          (float*)up, (float*)un, T, n, K);
  }
  return (int)cudaGetLastError();
}

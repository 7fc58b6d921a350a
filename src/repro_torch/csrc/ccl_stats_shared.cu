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
// Accuracy and repeatability: every sum over K is accumulated in fp64 (the
// product of two fp32 values is exact in fp64) in a fixed order, and
// rounded to fp32 once.  An fp32 sum of K = 960 products whose partial sums
// are of order 1 is off by a few 1e-7, which is the whole tolerance of a
// near-zero dot product; in fp64 the result is the correctly rounded one in
// nearly every case, as the plain version's is, whatever the scale of the
// data.
//
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s fp64 on the tensor cores, 34
// outside them): bytes.  At the slice's T = 8*1023 = 8,184, K = 960, n = 64
// the kernel must read u and p once (62.9 MB) and the negatives once (0.25
// MB), about 19 us; un is a (T,K)x(K,n) product of 1.0 GFLOP, 15 us on the
// fp64 tensor cores and 31 us in fp64 FMAs outside them, so un runs on the
// tensor cores and the loads have to stream at the memory's rate.
//
// Design:
// - Loads: a block takes BM = 32 rows and BN = 64 negatives and walks K in
//   chunks of BK = 64 through a ring of STAGES = 3 chunks in shared memory,
//   filled with cp.async (16-byte copies where K % 4 == 0 and the rows are
//   16-byte aligned, 4-byte copies otherwise; out-of-range rows, negatives
//   and k are zero-filled): two chunks, 32 KB of u and p in 256-byte row
//   pieces, are in flight per block while the third is computed.  u and p
//   stream from device memory (.cg); the 245 KB of negatives are read
//   through L1 and L2 (.ca: the two blocks of an SM share them).  Chunks
//   are staged as fp32 and converted to fp64 in registers as the fragments
//   are built, each element once per block.
// - un on the fp64 tensor cores: mma.sync m16n8k16 f64 (sm_90).  Each of
//   the 4 warps takes one 16-wide k slice of every chunk and the whole 32 x
//   64 output tile (2 x 8 MMA tiles, 64 fp64 accumulators a thread); after
//   the K loop the warps' tiles are summed through shared memory in warp
//   order.  A lane's four k slots of an MMA name four consecutive k, so
//   every fragment row is one 16-byte shared load; staged rows keep their
//   16-byte pieces XOR-swizzled so those loads are free of bank conflicts
//   without padding.
// - uu, pp, up: from the same u fragments (and p at the same positions) in
//   fp64 FMAs, each thread over its own k in K order, then across the 4
//   lanes of a row group (shuffles) and the 4 warps (shared memory) in a
//   fixed order.  Only blocks of the first negative column compute them.
// - Grid: ceil(T/32) x ceil(n/64) blocks of 4 warps, 2 resident per SM (99
//   KB of shared memory each): 256 blocks at the slice's shape.  Rows past T
//   and columns past n are computed on zeros and not written, so a ragged T,
//   n or K needs no padding.
// What bounds it in practice: tools/probe_stats_shared.py times this kernel
// against copies of itself without its loads and without its compute.  The
// loads of u and p through the ring alone take most of the kernel's time,
// more so when the L2 holds dirty lines that the reads must first write
// back (as after chip_smoke.py's flush, a 256 MB write); the compute alone
// is the smaller part, and the two overlap only in part (PERF.md).
// Every order of summation is fixed, so two calls give the same bits.  nn
// is computed once, by its own small kernel (one warp per negative).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;                 // rows per block
constexpr int BN = 64;                 // negatives per block
constexpr int BK = 64;                 // K per ring stage
constexpr int STAGES = 3;              // ring depth
constexpr int KW = BK / 16;            // warps, one k16 slice of each stage each
constexpr int THREADS = 32 * KW;
constexpr int U_FLOATS = BM * BK;      // one stage of u (and of p)
constexpr int STAGE_FLOATS = 2 * U_FLOATS + BN * BK;
constexpr int RED_LD = BN + 8;         // row stride of the warps' un tiles (doubles)
constexpr int RING_BYTES = STAGES * STAGE_FLOATS * 4;
constexpr int RED_BYTES = KW * BM * RED_LD * 8;
constexpr int SMEM_BYTES = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
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

// cp.async of 16 (or 4) bytes; bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok, bool l1) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = ok ? 16 : 0;
  if (l1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes));
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Staged layout: row r of a stage holds its BK floats as BK/4 16-byte pieces,
// piece c at position c ^ swz(r).  A quarter warp reading fragments touches
// two rows (r, r + 1) and four pieces of each; the swizzle puts the two rows
// on opposite halves of the 32 banks.
__device__ __forceinline__ int swz(int r) { return (r & 1) << 2; }

// Stage rows [row0, row0 + rows) x k [k0, k0 + BK) of src (valid_rows x K)
// into dst; out-of-range elements read `dummy` with 0 bytes.
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int rows,
                                           int row0, int valid_rows, int k0, int K,
                                           const float* dummy, bool l1) {
  if (VEC) {
    for (int i = threadIdx.x; i < rows * (BK / 4); i += THREADS) {
      const int r = i / (BK / 4), c = i % (BK / 4);
      const int gr = row0 + r, gk = k0 + 4 * c;
      const bool ok = gr < valid_rows && gk < K;
      cp_async16(dst + r * BK + 4 * (c ^ swz(r)), ok ? src + (size_t)gr * K + gk : dummy, ok,
                 l1);
    }
  } else {
    for (int i = threadIdx.x; i < rows * BK; i += THREADS) {
      const int r = i / BK, k = i % BK;
      const int gr = row0 + r, gk = k0 + k;
      const bool ok = gr < valid_rows && gk < K;
      cp_async4(dst + r * BK + 4 * ((k >> 2) ^ swz(r)) + (k & 3),
                ok ? src + (size_t)gr * K + gk : dummy, ok);
    }
  }
}

// Four consecutive k of staged row r: its 16-byte piece c.
__device__ __forceinline__ float4 piece(const float* stage, int r, int c) {
  return *reinterpret_cast<const float4*>(stage + r * BK + 4 * (c ^ swz(r)));
}

// fp32 -> fp64, exact.
__device__ __forceinline__ double widen(float x) { return (double)x; }

// D (16x8) += A (16x16, row) * B (16x8, col) in fp64 (sm_90).  Fragments (g =
// lane / 4, q = lane % 4): a[i] = A[g + 8*(i%2)][q + 4*(i/2)], b[j] =
// B[q + 4*j][g], d = {D[g][2q], D[g][2q+1], D[g+8][2q], D[g+8][2q+1]}.  A
// product over k needs A's and B's k slots to name the same k, nothing
// more, so the kernel gives lane q's slots q + 4*j the four consecutive k
// 4*q + j of its k16 slice: each fragment row is one 16-byte piece.
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

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
stats_kernel(const float* __restrict__ u, const float* __restrict__ p,
             const float* __restrict__ negs, float* __restrict__ uu, float* __restrict__ pp,
             float* __restrict__ up, float* __restrict__ un, int T, int n, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double nrm_s[KW][BM][3];      // warps' uu, pp, up per row
  float* ring = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                 // fragment row group
  const int q = lane & 3;                  // lane in the group
  const int pc = 4 * warp + q;             // the lane's 16-byte piece of a staged row
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const bool norms = blockIdx.y == 0;      // one block column writes uu, pp, up
  const int chunks = (K + BK - 1) / BK;

  auto load = [&](int chunk) {
    float* s = ring + (chunk % STAGES) * STAGE_FLOATS;
    const int k0 = chunk * BK;
    stage_rows<VEC>(s, u, BM, row0, T, k0, K, u, false);
    if (norms) stage_rows<VEC>(s + U_FLOATS, p, BM, row0, T, k0, K, u, false);
    stage_rows<VEC>(s + 2 * U_FLOATS, negs, BN, col0, n, k0, K, u, true);
  };

  double acc[2][BN / 8][4];                // [m tile][n tile][fragment]
  double nr[2][2][3];                      // [m tile][row half][uu, pp, up]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < BN / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0;
#pragma unroll
    for (int h = 0; h < 2; ++h) nr[mi][h][0] = nr[mi][h][1] = nr[mi][h][2] = 0.0;
  }

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();   // chunk c has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and chunk c-1's stage is free
    if (c + STAGES - 1 < chunks) load(c + STAGES - 1);
    cp_async_commit();

    const float* su = ring + (c % STAGES) * STAGE_FLOATS;
    const float* sp = su + U_FLOATS;
    const float* sn = sp + U_FLOATS;
    double a[2][8];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = piece(su, 16 * mi + 8 * h + g, pc);
        a[mi][h] = widen(v.x);
        a[mi][h + 2] = widen(v.y);
        a[mi][h + 4] = widen(v.z);
        a[mi][h + 6] = widen(v.w);
      }
#pragma unroll
    for (int ni = 0; ni < BN / 8; ++ni) {
      const float4 v = piece(sn, 8 * ni + g, pc);
      const double b[4] = {widen(v.x), widen(v.y), widen(v.z), widen(v.w)};
      mma_f64(acc[0][ni], a[0], b);
      mma_f64(acc[1][ni], a[1], b);
    }
    if (norms) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = piece(sp, 16 * mi + 8 * h + g, pc);
          const double y[4] = {widen(v.x), widen(v.y), widen(v.z), widen(v.w)};
          double* r = nr[mi][h];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const double x = a[mi][h + 2 * j];
            r[0] = fma(x, x, r[0]);
            r[1] = fma(y[j], y[j], r[1]);
            r[2] = fma(x, y[j], r[2]);
          }
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                 // the ring is free: it holds the warps' tiles now

  // The warps' un tiles, [warp][BM][RED_LD]: partial sums over their k slices.
  double* red = reinterpret_cast<double*>(smem);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < BN / 8; ++ni) {
      double* d = red + (warp * BM + 16 * mi + g) * RED_LD + 8 * ni + 2 * q;
      *reinterpret_cast<double2*>(d) = make_double2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<double2*>(d + 8 * RED_LD) =
          make_double2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  if (norms) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          double v = nr[mi][h][j];
          v += __shfl_xor_sync(FULL, v, 1);
          v += __shfl_xor_sync(FULL, v, 2);
          if (q == 0) nrm_s[warp][16 * mi + 8 * h + g][j] = v;
        }
  }
  __syncthreads();

  // Sum the warps' partials in warp order.
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gr = row0 + r, gc = col0 + c;
    const double* t = red + r * RED_LD + c;
    double v = t[0];
#pragma unroll
    for (int w = 1; w < KW; ++w) v += t[w * BM * RED_LD];
    if (gr < T && gc < n) un[(size_t)gr * n + gc] = (float)v;
  }
  if (norms && tid < BM && row0 + tid < T) {
    double v[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      v[j] = nrm_s[0][tid][j];
#pragma unroll
      for (int w = 1; w < KW; ++w) v[j] += nrm_s[w][tid][j];
    }
    uu[row0 + tid] = (float)v[0];
    pp[row0 + tid] = (float)v[1];
    up[row0 + tid] = (float)v[2];
  }
}

template <bool VEC>
void launch_stats(const float* u, const float* p, const float* negs, float* uu, float* pp,
                  float* up, float* un, int T, int n, int K, cudaStream_t s) {
  cudaFuncSetAttribute(stats_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_BYTES);
  const dim3 grid((T + BM - 1) / BM, n > 0 ? (n + BN - 1) / BN : 1);
  stats_kernel<VEC><<<grid, THREADS, SMEM_BYTES, s>>>(u, p, negs, uu, pp, up, un, T, n, K);
}

}  // namespace

extern "C" int ccl_stats_shared(const void* u, const void* p, const void* negs, void* uu,
                                void* pp, void* up, void* nn, void* un, int T, int n, int K,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) nn_kernel<<<(n + 7) / 8, 256, 0, s>>>((const float*)negs, (float*)nn, n, K);
  if (T > 0) {
    const bool vec = K % 4 == 0 &&
                     ((uintptr_t)u | (uintptr_t)p | (uintptr_t)negs) % 16 == 0;
    if (vec)
      launch_stats<true>((const float*)u, (const float*)p, (const float*)negs, (float*)uu,
                         (float*)pp, (float*)up, (float*)un, T, n, K, s);
    else
      launch_stats<false>((const float*)u, (const float*)p, (const float*)negs, (float*)uu,
                          (float*)pp, (float*)up, (float*)un, T, n, K, s);
  }
  return (int)cudaGetLastError();
}

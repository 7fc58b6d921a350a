// Deterministic sorted segment sum with long runs cut into fixed pieces:
//     out[s, :] = sum of values[order[i], :] over the sorted positions i with sidx[i] == s
//
// Replaces no TPU kernel.  It replaces, on the card, torch.segment_reduce and
// the sorted copy values[order] in front of it, which core/tiling.py's
// segment sums (the slot reduction, the tile write-through, the int8 update's
// duplicate pre-reduce) ran.  segment_reduce gives each segment one thread a
// column and sums the run in order, so its time follows the longest run: the
// int8 item update's padding run of ~1.6M lanes took 154 ms where reading its
// bytes once takes 0.25 ms.
//
// Order of the adds (the contract the plain version in
// kernels/segment_sum.py repeats): each run of equal sidx is cut into pieces
// of at most `piece` positions counted from the run's start; each piece is
// summed in order from +0 with correctly rounded fp32 adds (__fadd_rn, no
// contraction), and a run's pieces are then added in piece order.  A run of
// up to `piece` positions thus gets segment_reduce's bits, and every run the
// same bits on every call and every card.  No atomics touch the values.
// Positions with sidx == S (the dropped entries, sorted last) are never read.
//
// Bound on an H100 (3.35 TB/s): bytes.  Each kept value row is read once
// (through `order`, so the sorted copy is never written), sidx and order once,
// and each output row written once: a memset zeroes the output (empty
// segments give 0), then two launches, both sized from M, with no host sync:
//   1. segment_sum_pieces: one warp per chunk of `piece` sorted positions
//      and 32-column slice.  The warp owns the pieces that start in its
//      chunk: the runs that start there and, when the chunk opens inside a
//      run, that run's piece starting at r0 + k * piece (r0, the run's start,
//      found by a 32-way warp search).  It walks its pieces in order, 32
//      positions a round trip: their 32 value rows are requested at once,
//      together with the next 32 positions' sidx and order.  Only a
//      block's last piece can fill up, so the rows to add are known before
//      the adds, and a block inside one piece takes its 32 adds straight
//      through.  It writes a
//      run's first piece to out[s] and a later piece to scratch[chunk] (at
//      most one later piece starts in a chunk); meta[chunk] holds that
//      piece's run start, or -1.  A warp walks at most 2 * piece
//      positions, so its chain of dependent adds is at most `piece` long.
//   2. segment_sum_combine (only when M > piece): the block of the chunk that
//      holds a run's second piece adds scratch[chunk], scratch[chunk + 1], ...
//      (consecutive chunks whose meta is the run's start) onto out[s] in
//      order; its warps stage CWARPS * CUNROLL pieces a round in shared
//      memory and prefetch the next round while warp 0 adds.  That chain is
//      at most M / piece adds.
// The second and later pieces are counted into *engaged (one int64 atomic a
// warp that owns such a piece, on a counter, never on a value).
// Offsets are 64-bit (tables and num_segments past 2^31 elements).
//
// What the card showed (tools/probe_kernels.py, part segment_sum; PERF.md,
// kernel #8): a round trip of a warp's 32 rows costs 3-5 us even on an idle
// card, and as much on rows already in sorted order, so a warp's walk and
// the combine are latency-bound where few warps run (the int8 update at
// batch 1,024) and the read runs near the card's rate where many do (the
// slot reduction, ~2.7 TB/s).  `piece` trades the two: no piece of
// 256-2,048 is best at all three of the benchmark's shapes (256 at batch
// 1,024, 2,048 at the others), and 512 is within 13% of the best at each.
// L2-only or streaming loads and 1 or 8 warps a block change nothing.  The
// 32 loads are unconditional so that they stay in one basic block, where
// the compiler issues them back to back (32 LDG.128 in a row in the SASS).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;        // chunks per block of segment_sum_pieces
constexpr int CWARPS = 8;       // warps per block of segment_sum_combine
constexpr int CUNROLL = 8;      // pieces each of them loads per round
constexpr int ROUND = CWARPS * CUNROLL;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float zero(float) { return 0.f; }
__device__ __forceinline__ float4 zero(float4) { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// The first position j in [a, b] with sidx[j] >= v, given that every position
// in [a, b) may be read (sidx[b] is never read).  Each round trip narrows the
// interval 32-fold.
__device__ int64_t warp_lower_bound(const int64_t* __restrict__ sidx, int64_t a, int64_t b,
                                    int64_t v, int lane) {
  while (b - a > 32) {
    const int64_t q = a + (b - a) * lane / 32;
    const int n = __popc(__ballot_sync(FULL, sidx[q] < v));
    if (n == 0) return a;
    const int64_t qn = a + (b - a) * (n - 1) / 32;
    b = n < 32 ? a + (b - a) * n / 32 : b;
    a = qn + 1;
  }
  const int64_t q = a + lane;
  return a + __popc(__ballot_sync(FULL, q < b && sidx[q] < v));
}

// V is float4 (K % 4 == 0, 16-byte aligned rows) or float; a row holds
// `width` elements of V.  The grid's y dimension takes 32-element column
// slices of the rows.
template <typename V>
__global__ void __launch_bounds__(32 * WARPS)
segment_sum_pieces(const int64_t* __restrict__ sidx, const int64_t* __restrict__ order,
                   const V* __restrict__ values, V* __restrict__ out, V* __restrict__ scratch,
                   int64_t* __restrict__ meta, unsigned long long* __restrict__ engaged,
                   int64_t M, int64_t S, int piece, int width) {
  const int64_t c = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= (M + piece - 1) / piece) return;
  const int col = blockIdx.y * 32 + lane;
  const bool on = col < width;
  const int ccol = on ? col : width - 1;
  const bool lead = blockIdx.y == 0 && lane == 0;     // writes meta and counts
  const int64_t lo = c * piece;
  const int64_t hi = lo + piece < M ? lo + piece : M;

  // The first piece this warp owns: its start p and its index k in its run.
  const int64_t v = sidx[lo];
  int64_t p = -1, k = 0, r0 = lo;
  if (v < S) {
    const int64_t prev = lo > 0 ? sidx[lo - 1] : -1;
    if (prev != v) {
      p = lo;                                           // a run starts here
    } else {                                            // inside a run that started before
      r0 = warp_lower_bound(sidx, 0, lo, v, lane);
      k = (lo - r0 + piece - 1) / piece;
      const int64_t q = r0 + k * piece;                 // in [lo, hi) unless past M
      if (q < M && sidx[q] == v) {
        p = q;
      } else {                                          // the run ends first: the next one
        k = 0;
        p = warp_lower_bound(sidx, lo, q < M ? q : M, v + 1, lane);
        if (p >= hi || sidx[p] >= S) p = -1;
      }
    }
  }
  if (lead) meta[c] = p >= 0 && k > 0 ? r0 : -1;
  if (p < 0) return;
  if (lead && k > 0) atomicAdd(engaged, 1ull);

  // Walk the owned pieces in order.  Pieces tile the positions, so the walk
  // is contiguous; it stops at the first run start at or past hi, at a
  // dropped or missing position, or where its last piece is full.  dst is
  // the row the current piece's sum goes to: out[s], or scratch[c] for a
  // later piece of a run (only the first piece of the walk can be one).
  int64_t start = p;                                    // the current piece's start
  V* dst = k == 0 ? out + sidx[p] * width : scratch + c * width;
  int64_t prev_id = sidx[p];
  V acc = zero(V());
  int64_t sj = p + lane < M ? sidx[p + lane] : S;
  int64_t oj = order != nullptr && p + lane < M ? order[p + lane] : p + lane;
  for (int64_t j0 = p;; j0 += 32) {
    int64_t sp = __shfl_up_sync(FULL, sj, 1);
    if (lane == 0) sp = prev_id;
    const bool rs = sj != sp;                           // a run starts at j0 + lane
    const unsigned stop = __ballot_sync(FULL, rs && (j0 + lane >= hi || sj >= S));
    const int rows = stop ? __ffs(stop) - 1 : 32;
    if (rows == 0) break;
    // All 32 loads unconditional, in one basic block, so that they are
    // issued back to back: positions past `rows` reread the block's first
    // row (kept, since rows > 0) and idle lanes the row's last element.
    V buf[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int64_t o = __shfl_sync(FULL, oj, t < rows ? t : 0);
      buf[t] = values[o * width + ccol];
    }
    // The next 32 positions' ids and permutation, in flight with the rows.
    const int64_t jn = j0 + 32 + lane;
    const bool next = rows == 32 && jn < M;
    const int64_t sn = next ? sidx[jn] : S;
    const int64_t on_ = order != nullptr && next ? order[jn] : jn;
    // The runs that start among the rows (all before hi), and the rows to
    // add: only the block's last piece can fill up, at its start + piece.
    const unsigned starts = __ballot_sync(FULL, rs) & (rows == 32 ? FULL : (1u << rows) - 1u);
    if (starts) start = j0 + 31 - __clz(starts);
    const int n = start + piece - j0 < rows ? (int)(start + piece - j0) : rows;
    if (starts == 0 && n == 32) {                       // all 32 rows in the current piece
#pragma unroll
      for (int t = 0; t < 32; ++t) acc = add(acc, buf[t]);
    } else {
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        if (t >= n) break;
        if ((starts >> t) & 1u) {
          if (on) dst[col] = acc;
          acc = zero(V());
          dst = out + __shfl_sync(FULL, sj, t) * width;
        }
        acc = add(acc, buf[t]);
      }
    }
    if (n < 32) break;
    prev_id = __shfl_sync(FULL, sj, 31);
    sj = sn;
    oj = on_;
  }
  if (on) dst[col] = acc;
}

// One block per chunk and 32-column slice; only the block of the chunk that
// holds a run's second piece works.
template <typename V>
__global__ void __launch_bounds__(32 * CWARPS)
segment_sum_combine(const int64_t* __restrict__ sidx, const V* __restrict__ scratch,
                    const int64_t* __restrict__ meta, V* __restrict__ out, int64_t nchunks,
                    int piece, int width) {
  const int64_t c = blockIdx.x;
  const int64_t r0 = meta[c];
  if (r0 < 0 || r0 / piece + 1 != c) return;
  __shared__ V tile[ROUND][32];
  __shared__ bool ok[ROUND];
  __shared__ bool more;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.y * 32 + lane;
  const bool on = col < width;
  const int ccol = on ? col : width - 1;
  const int64_t s = sidx[r0];
  V acc = warp == 0 && on ? out[s * width + col] : zero(V());

  // Each warp's CUNROLL pieces of a round: values and whether they are the
  // run's (scratch of other chunks is read but never added).
  V x[CUNROLL];
  bool mine[CUNROLL];
  auto load = [&](int64_t base) {
#pragma unroll
    for (int t = 0; t < CUNROLL; ++t) {
      const int64_t slot = base + warp * CUNROLL + t;
      const int64_t at = slot < nchunks ? slot : nchunks - 1;
      x[t] = scratch[at * width + ccol];
      mine[t] = slot < nchunks && meta[at] == r0;
    }
  };
  load(c);
  for (int64_t base = c;; base += ROUND) {
#pragma unroll
    for (int t = 0; t < CUNROLL; ++t) {
      tile[warp * CUNROLL + t][lane] = x[t];
      if (lane == 0) ok[warp * CUNROLL + t] = mine[t];
    }
    __syncthreads();
    load(base + ROUND);                                 // in flight while warp 0 adds
    if (warp == 0) {
      int n = 0;
      while (n < ROUND && ok[n]) acc = add(acc, tile[n++][lane]);
      if (lane == 0) more = n == ROUND;
    }
    __syncthreads();
    if (!more) break;
  }
  if (warp == 0 && on) out[s * width + col] = acc;
}

template <typename V>
int launch(const int64_t* sidx, const int64_t* order, const float* values, float* out,
           float* scratch, int64_t* meta, unsigned long long* engaged, int64_t M, int64_t S,
           int width, int piece, cudaStream_t stream) {
  const int64_t nchunks = (M + piece - 1) / piece;
  const dim3 grid((unsigned)((nchunks + WARPS - 1) / WARPS), (unsigned)((width + 31) / 32));
  segment_sum_pieces<V><<<grid, 32 * WARPS, 0, stream>>>(
      sidx, order, (const V*)values, (V*)out, (V*)scratch, meta, engaged, M, S, piece, width);
  if (M > piece) {
    const dim3 cgrid((unsigned)nchunks, (unsigned)((width + 31) / 32));
    segment_sum_combine<V><<<cgrid, 32 * CWARPS, 0, stream>>>(
        sidx, (const V*)scratch, meta, (V*)out, nchunks, piece, width);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out (S, K) fp32, zeroed here; scratch (ceil(M / piece), K) fp32 and meta
// (ceil(M / piece),) int64, both uninitialised; engaged one int64 that the
// kernel adds to.  order may be null (values already sorted).
extern "C" int segment_sum_sorted(const void* sidx, const void* order, const void* values,
                                  void* out, void* scratch, void* meta, void* engaged,
                                  long long M, long long S, int K, int piece, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S > 0 && K > 0) {
    const cudaError_t err = cudaMemsetAsync(out, 0, (size_t)S * K * sizeof(float), st);
    if (err != cudaSuccess) return (int)err;
  }
  if (M <= 0 || S <= 0 || K <= 0) return (int)cudaGetLastError();
  const bool vec = K % 4 == 0 &&
                   ((uintptr_t)values | (uintptr_t)out | (uintptr_t)scratch) % 16 == 0;
  if (vec)
    return launch<float4>((const int64_t*)sidx, (const int64_t*)order, (const float*)values,
                          (float*)out, (float*)scratch, (int64_t*)meta,
                          (unsigned long long*)engaged, M, S, K / 4, piece, st);
  return launch<float>((const int64_t*)sidx, (const int64_t*)order, (const float*)values,
                       (float*)out, (float*)scratch, (int64_t*)meta,
                       (unsigned long long*)engaged, M, S, K, piece, st);
}

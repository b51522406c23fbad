// Masked natural-cubic spline restraint energy, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel trx2dy/ops/spline_energy.py:_spline_kernel
// (launched by _spline_energy_fwd_pallas, public op spline_energy_batch).
// For every query q it finds the knot interval k = clip(#{x[:K-1] <= q} - 1,
// 0, K-2) (right-open intervals; q == x[K-1] falls in the last one),
// evaluates the natural cubic of its pair's table there, extrapolates
// linearly with the boundary slope outside [x[0], x[K-1]], and returns in
// the same pass the per-decoy masked sum of values and dE/dq (zero where
// masked), so the backward pass is one multiply.
//
// Three entry points:
//   dense  up to four terms at once, each y, m (L*L, K_t), x (K_t),
//          mask (L*L), q (B, L*L): the TPU kernel's own layout
//          (spline_energy_batch), run by the single-program fold
//          (trx2dy/physics/folder.py:_batch_energy via
//          energy.batched_energy_fused). One launch per energy evaluation
//          writes every term's deriv (B, L*L) and the (n_terms, B) sums.
//   pairs  up to four terms at once, each y, m (P_t, K_t), x (K_t),
//          q (P_t, B), act (P_t): the compacted pair lists the production
//          fold evaluates (trx2dy/physics/spline.py:_eval_with_deriv_pb via
//          compact.compact_restraint_energy_batch). One launch per energy
//          evaluation writes every term's deriv and the (n_terms, B) sums.
//   lanes  the pair entry with per-lane tables behind a lane -> row map:
//          each of up to four terms has tab (P_t, U_t, K_t - 1, 4), row
//          (B,), x (K_t), act (P_t, B), q (P_t, B), the Dynamics sampler's
//          shared pair list (trx2dy/physics/spline.py:
//          masked_spline_energy_lanes via
//          compact.compact_restraint_energy_union). The U_t table rows are
//          the distinct pool rows (histograms) the fold's lanes use; lane b
//          reads row[b]. Each interval k of a row is one float4
//          (y[k], y[k+1], m[k], m[k+1]). One launch per energy evaluation,
//          as for the pair entry.
//
// What bounds it on an H100: per query it reads q, an activity byte and one
// interval's four table values and writes one derivative, with ~40 flops,
// far below the 67 TFLOP/s f32 rate, so it is bound by bytes: one
// evaluation of the fold at L=150, B=50 moves ~44 MB (q, deriv, the table
// rows), about 13 us at 3.35 TB/s; the dense entry's four terms at the
// same size ~45 MB (the active pairs' q and table rows, every deriv),
// 13.4 us, of which it takes ~34 us as well with the L2 flushed as warm
// (scripts/kernel_variants.py): what holds it is on the SM, each query's
// instructions (knot search, cubic, selects, addressing) and their latency
// on 24 warps an SM, not device memory. The lanes entry moves q, act and
// deriv per (pair, lane), 9 bytes, and 16 bytes per distinct (pair, row,
// interval) its active queries touch: at a full L=150 union with B=32 that
// is ~10-40 MB by the lane map, 3-12 us; at L=64 under 3 us, where the
// launch's latency chain (activity and query, interval search, table
// load, derivative store, two fenced rendezvous for the sums) and not the
// bytes is what it waits on.
//
// Dense design (the tables are shared by every decoy, so the work is to
// read them once and stream q and deriv past them):
//  - one launch for all terms, as the pair entry: a block takes a tile of
//    DENSE_TILE consecutive pairs of one term and walks every decoy of its
//    decoy chunk; the host makes one chunk of all B decoys wherever the
//    tiles alone fill a wave of resident blocks (at L=150, 4 terms: 704
//    tiles), so each table row crosses from device memory once per
//    evaluation (smaller L splits B into chunks that re-read the tile from
//    L2);
//  - the block copies its tile's table rows, contiguous in (L*L, K), into
//    shared memory once with 16-byte loads, DENSE_COPY of y and of m in
//    flight a thread, skipping those of masked pairs, and stores them as
//    (y[k], m[k]) pairs in rows of odd stride K|1: a thread keeps one pair,
//    so the 32 threads of a warp read their rows at one interval from
//    distinct banks, one 8-byte load for k and one for k+1;
//  - 128 threads are the tile's 128 pairs, 6 blocks to an SM (80
//    registers a thread), each thread with DENSE_ELEMS decoys' q in use
//    and the next step's in flight (the first step's load beside the
//    table copy); q[b, tile] is read and deriv[b, tile] written coalesced,
//    a masked pair's q never;
//  - per query: the pair entry's branch-free search over knots padded with
//    +inf, unrolled to the depth this term's K needs (6 steps at K=35, 5 at
//    28, 4 at 16), its per-interval x, 1/h, h/6 and h*h/6 (one 16-byte
//    shared load), and the cubic at t clamped to [0, 1] plus the slope
//    times the query's distance past the end knot, so a query outside the
//    knots evaluates the first or last interval with the same instructions
//    (selects and min/max, no branch);
//  - per decoy, a warp's values are summed by a reduce-scatter (6 shuffles
//    for 4 decoys), the warps in order by one thread, and the per-block
//    partials are finished in the kernel by the pair entry's fixed-order
//    two-level sum, so repeated launches are bit-identical.

// Pair and lanes design (one kernel body, LANES a template flag that only
// changes the table load and the activity index), for launch count and
// latency rather than bytes:
//  - one launch for all terms: the x-blocks are split among the terms in
//    order, each block walks `nit` tiles of PAIR_ELEMS x R consecutive
//    pairs of one term, with nit chosen on the host so that the grid is
//    about one wave of resident blocks (each block pays its prologue and
//    its end-of-block fence and atomic once);
//  - a block is R rows of W = min(B, PAIR_THREADS) decoy lanes, so a thread
//    keeps one decoy, consecutive threads read consecutive q elements and no
//    lane idles except the PAIR_THREADS mod W remainder;
//  - a thread starts the loads of all its PAIR_ELEMS elements before it uses
//    any; the interval search is branch-free over the knots padded to 64
//    with +inf in shared memory (6 steps), and queries outside the knots
//    read the first or last interval, so every element makes the same
//    table load with no divergent branch;
//  - lanes: the sampler folds a few lanes per histogram (the initial fold
//    32 lanes from 2 histograms, a chain step 32 lanes from 16), so the
//    tables are stored once per used pool row, not once per lane: 2-16x
//    fewer table bytes, and the initial fold's tables fit the 50 MB L2 at
//    L=64. A thread reads its lane's row once before its loop; the lanes
//    of a warp (one pair, consecutive lanes) that share a row and an
//    interval read one address, which the hardware serves once;
//  - lanes: the four values an interval needs are one aligned float4, one
//    16-byte load from one sector where the per-lane y, m rows took four
//    scalar loads from two arrays (~2.25 sectors per query); the values
//    feed the same expressions, so the results are the per-lane layout's;
//  - each interval's 1/h, h/6 and h*h/6 are computed once per block into
//    shared memory, so an element does no division (1/h times a value is
//    within an ulp or two of the plain version's division);
//  - offsets are 32-bit: the entry refuses terms with P*B or P*K >= 2^31,
//    and the lanes entry terms with P*U*(K-1)*4 >= 2^31;
//  - the per-decoy sum is finished in the kernel, deterministically, in two
//    levels so that no block sums more than a few values per decoy: each
//    block writes its fixed-order partials; the last block of each group of
//    GROUP blocks (a __threadfence and an atomicAdd on the group's counter,
//    which it resets) sums the group's partials in block order; the last
//    group to finish sums every term's group partials in group order into
//    (n_terms, B). The order of every sum is fixed, so repeated launches
//    are bit-identical.
// A cp.async prefetch of the next tile's q and act into shared memory was
// measured against this design (scripts/kernel_variants.py) and left out:
// it gained nothing (PERF.md section 6).
// A masked element is never evaluated and gives 0 and 0, so an inf or NaN
// there never leaks (the plain version selects, with the same result).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// One term's stage constants as the host holds them (ctypes mirrors it).
// The lanes entry's y is the interval table tab (P, U, K-1, 4), 16-byte
// aligned, m is unused, act is (P, B) and row (B,) maps each lane to its
// table row; the pair entry leaves row null and U 0; the dense entry's act
// is the (L*L) mask, P = L*L.
struct PairTerm {
  const float* y;          // (P, K); lanes: tab (P, U, K-1, 4)
  const float* m;          // (P, K); lanes: unused
  const float* x;          // (K,)
  const uint8_t* act;      // (P,); lanes: (P, B)
  const int* row;          // lanes: (B,) lane -> table row in [0, U)
  long long P;
  int K;
  int U;                   // lanes: table rows
};

namespace {

constexpr int MAX_K = 64;

// dense entry: DENSE_THREADS threads = DENSE_TILE pairs x DENSE_LANES decoy
// lanes, DENSE_ELEMS decoys in flight per thread
constexpr int DENSE_TILE = 128;
constexpr int DENSE_THREADS = 128;
constexpr int DENSE_LANES = DENSE_THREADS / DENSE_TILE;
constexpr int DENSE_ELEMS = 4;
constexpr int DENSE_BATCH = DENSE_LANES * DENSE_ELEMS;   // decoys per step
constexpr int DENSE_WARPS = DENSE_TILE / 32;             // warps per lane
constexpr int DENSE_BLOCKS_PER_SM = 6;   // resident blocks the grid aims at
constexpr int DENSE_COPY = 4;   // table float4s a thread loads at once
static_assert(DENSE_ELEMS == 4, "the reduce-scatter is written for 4");
static_assert(DENSE_TILE % 32 == 0 && DENSE_THREADS % DENSE_TILE == 0,
              "a warp keeps one decoy lane");
// pair entry: PAIR_THREADS threads per block, PAIR_ELEMS pairs per thread,
// GROUP blocks per first-level sum
constexpr int PAIR_THREADS = 256;
constexpr int PAIR_ELEMS = 4;
constexpr int MAX_TERMS = 4;
constexpr int GROUP = 64;
constexpr int PAIR_BLOCKS_PER_SM = 4;   // resident blocks the grid aims at
constexpr int SUM_LOADS = 16;   // partials a thread loads at once when summing

// ---------------------------------------------------------------- pairs

struct PairLaunch {        // the kernel's parameter block, passed by value;
  const float* y[MAX_TERMS];     // per term, indexed only by constants so
  const float* m[MAX_TERMS];     // that it stays in the parameter bank
  const float* x[MAX_TERMS];
  const uint8_t* act[MAX_TERMS];
  const int* row[MAX_TERMS];     // lanes: (B,) lane -> table row
  const float* q[MAX_TERMS];     // (P_t, B)
  float* deriv[MAX_TERMS];       // (P_t, B)
  long long P[MAX_TERMS];
  int K[MAX_TERMS];
  int U[MAX_TERMS];              // lanes: table rows
  int block0[MAX_TERMS + 1];     // first x-block of each term; unused = end
  int group0[MAX_TERMS + 1];     // first group of each term; unused = end
  int n_terms;
  int B;
  int W;                         // decoy lanes per row, min(B, PAIR_THREADS)
  int R;                         // rows per block, PAIR_THREADS / W
  int nit;                       // tiles of R x PAIR_ELEMS pairs per block
  float* partial;                // (gridDim.x, B) per block
  float* gpartial;               // (n_groups, B) per group
  float* sums;                   // (n_terms, B)
  unsigned int* counter;         // gridDim.y final counters, then
                                 // gridDim.y x n_groups group counters;
                                 // all 0 between launches
};

template <typename X, int N>
__device__ __forceinline__ X pick(const X (&v)[N], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// #{xs[0 .. 63] <= q} for knots padded with +inf: six branch-free steps
// (a NaN q counts 0). Padding never counts for a finite q, and counting
// x[K-1] too changes k only where q == x[K-1], which the clip maps to K-2
// as the TPU kernel's count over x[:K-1] does. With TOP the largest power
// of two <= K - 1, the steps TOP, TOP/2, .., 1 count the knots up to index
// 2 TOP - 2 >= K - 2, which is all the clip to K - 2 needs.
template <int TOP = 32>
__device__ __forceinline__ int count_le(const float* __restrict__ xs,
                                        float q) {
  int pos = 0;
#pragma unroll
  for (int s = TOP; s > 0; s >>= 1) pos += (xs[pos + s - 1] <= q) ? s : 0;
  return pos;
}

template <int N>
struct Int {
  static constexpr int value = N;
};

// Sum of rows first, first + R, ... < end of src (rows of B floats) at
// column b, in that order: the first SUM_LOADS loads are all in flight before
// any add. Reads bypass L1 (other blocks wrote them).
__device__ __forceinline__ float strided_sum(const float* src, int first,
                                             int end, int R, int B, int b,
                                             bool on) {
  float v[SUM_LOADS];
#pragma unroll
  for (int i = 0; i < SUM_LOADS; ++i) {
    const int j = first + i * R;
    v[i] = on && j < end ? __ldcg(src + (long long)j * B + b) : 0.f;
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < SUM_LOADS; ++i) s += v[i];
  if (on)
    for (int j = first + SUM_LOADS * R; j < end; j += R)
      s += __ldcg(src + (long long)j * B + b);
  return s;
}

// red[rr * W + bl] summed over rr < R in order, by the row-0 threads;
// every thread passes the barriers.
__device__ __forceinline__ float rows_sum(float* red, float mine, int tid,
                                          int R, int W, int bl) {
  __syncthreads();
  red[tid] = mine;
  __syncthreads();
  float s = 0.f;
  if (tid < W)
    for (int rr = 0; rr < R; ++rr) s += red[rr * W + bl];
  return s;
}

// True in every thread of the block that is the last of `total` to arrive
// at `counter` (after its writes are fenced); that block resets it.
__device__ __forceinline__ bool arrive_last(unsigned int* counter,
                                            unsigned int total, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *flag = atomicAdd(counter, 1u) == total - 1;
    if (*flag) *counter = 0u;      // nobody else arrives: ready to reuse
  }
  __syncthreads();
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

template <bool LANES>
__global__ void __launch_bounds__(PAIR_THREADS, PAIR_BLOCKS_PER_SM)
spline_pairs_kernel(const PairLaunch a) {
  __shared__ float xs[MAX_K];        // knots, +inf past K
  __shared__ float ih[MAX_K];        // per interval k: 1 / h
  __shared__ float h6[MAX_K];        //                 h / 6
  __shared__ float hh6[MAX_K];       //                 h * h / 6
  __shared__ float red[PAIR_THREADS];
  __shared__ bool flag;

  const int bx = blockIdx.x;
  const int ti = (bx >= a.block0[1]) + (bx >= a.block0[2]) +
                 (bx >= a.block0[3]);           // this block's term, uniform
  const int K = pick(a.K, ti);
  const int tid = threadIdx.x;
  if (tid < MAX_K) {
    const float* xg = pick(a.x, ti);
    const float xa = tid < K ? xg[tid] : INFINITY;
    xs[tid] = xa;
    if (tid < K - 1) {
      const float h = xg[tid + 1] - xa;
      ih[tid] = 1.f / h;
      h6[tid] = h / 6.f;
      hh6[tid] = h * h / 6.f;
    }
  }
  __syncthreads();

  const int B = a.B, W = a.W, R = a.R;
  const int r = tid / W;
  const int bl = tid - r * W;
  const int b = blockIdx.y * W + bl;
  const bool lane_on = r < R && b < B;
  const int b0 = pick(a.block0, ti);
  float acc = 0.f;
  if (lane_on) {
    const int P = (int)pick(a.P, ti);
    const float* __restrict__ y = pick(a.y, ti);
    const float* __restrict__ m = pick(a.m, ti);
    const uint8_t* __restrict__ act = pick(a.act, ti);
    const float* __restrict__ q = pick(a.q, ti);
    float* __restrict__ deriv = pick(a.deriv, ti);
    // lanes: this lane's first float4 of pair 0; pair p adds p * pstride
    const float4* __restrict__ tab =
        LANES ? reinterpret_cast<const float4*>(y) +
                    pick(a.row, ti)[b] * (K - 1)
              : nullptr;
    const int pstride = LANES ? pick(a.U, ti) * (K - 1) : 0;
    const int tile = R * PAIR_ELEMS;
    const int first = (bx - b0) * a.nit * tile + r;
    const int last = min(first - r + a.nit * tile, P);
    for (int p0 = first; p0 < last; p0 += tile) {
      float qv[PAIR_ELEMS];
      bool in[PAIR_ELEMS], on[PAIR_ELEMS];
#pragma unroll
      for (int e = 0; e < PAIR_ELEMS; ++e) {      // every load started first
        const int p = p0 + e * R;
        in[e] = p < last;
        on[e] = in[e] && act[in[e] ? (LANES ? p * B + b : p) : 0] != 0;
        qv[e] = in[e] ? q[p * B + b] : 0.f;
      }
      int k[PAIR_ELEMS];
      float ya[PAIR_ELEMS], yb[PAIR_ELEMS], ma[PAIR_ELEMS], mb[PAIR_ELEMS];
#pragma unroll
      for (int e = 0; e < PAIR_ELEMS; ++e) {
        k[e] = min(max(count_le(xs, qv[e]) - 1, 0), K - 2);
        const int pr = on[e] ? p0 + e * R : 0;
        if (LANES) {           // one 16-byte load: y[k], y[k+1], m[k], m[k+1]
          const float4 v = __ldg(tab + pr * pstride + k[e]);
          ya[e] = v.x;
          yb[e] = v.y;
          ma[e] = v.z;
          mb[e] = v.w;
        } else {
          const int row = pr * K + k[e];
          ya[e] = y[row];
          yb[e] = y[row + 1];
          ma[e] = m[row];
          mb[e] = m[row + 1];
        }
      }
#pragma unroll
      for (int e = 0; e < PAIR_ELEMS; ++e) {
        const float qq = qv[e];
        const int kk = k[e];
        const float xa = xs[kk], ihk = ih[kk], h6k = h6[kk];
        const float dy = (yb[e] - ya[e]) * ihk;
        float v, d;
        if (qq < xs[0]) {            // k == 0: the first interval's row
          d = dy - h6k * (2.f * ma[e] + mb[e]);
          v = ya[e] + d * (qq - xa);
        } else if (qq > xs[K - 1]) { // k == K-2: the last interval's row
          d = dy + h6k * (ma[e] + 2.f * mb[e]);
          v = yb[e] + d * (qq - xs[kk + 1]);
        } else {
          const float t = (qq - xa) * ihk;
          const float u = 1.f - t;
          const float h2 = hh6[kk];
          v = u * ya[e] + t * yb[e] + (u * u * u - u) * h2 * ma[e] +
              (t * t * t - t) * h2 * mb[e];
          d = dy + h6k * (-(3.f * u * u - 1.f) * ma[e] +
                          (3.f * t * t - 1.f) * mb[e]);
        }
        if (!on[e]) v = d = 0.f;     // never evaluated: 0, 0
        acc += v;
        if (in[e]) deriv[(p0 + e * R) * B + b] = d;
      }
    }
  }
  const float blk = rows_sum(red, acc, tid, R, W, bl);   // rows in order
  if (tid < W && b < B) a.partial[(long long)bx * B + b] = blk;

  // first level: the last block of this group sums its partials
  const int n_groups = a.group0[MAX_TERMS];
  const int gl = (bx - b0) / GROUP;
  const int grp = pick(a.group0, ti) + gl;
  const int gb0 = b0 + gl * GROUP;
  const int b1 = ti == 0 ? a.block0[1] : ti == 1 ? a.block0[2]
               : ti == 2 ? a.block0[3] : a.block0[4];   // this term's end
  const int gend = min(gb0 + GROUP, b1);
  unsigned int* finals = a.counter;
  unsigned int* groups = a.counter + gridDim.y + blockIdx.y * n_groups;
  if (!arrive_last(groups + grp, gend - gb0, &flag)) return;
  const float gs = rows_sum(
      red, strided_sum(a.partial, gb0 + r, gend, R, B, b, lane_on), tid, R,
      W, bl);
  if (tid < W && b < B) a.gpartial[(long long)grp * B + b] = gs;

  // second level: the last group sums every term's group partials
  if (!arrive_last(finals + blockIdx.y, n_groups, &flag)) return;
  float s[MAX_TERMS];
#pragma unroll
  for (int u = 0; u < MAX_TERMS; ++u)
    s[u] = strided_sum(a.gpartial, a.group0[u] + r, a.group0[u + 1], R, B, b,
                       lane_on && u < a.n_terms);
#pragma unroll
  for (int u = 0; u < MAX_TERMS; ++u) {
    if (u < a.n_terms) {                       // uniform over the block
      const float tot = rows_sum(red, s[u], tid, R, W, bl);
      if (tid < W && b < B) a.sums[(long long)u * B + b] = tot;
    }
  }
}

// Tiles per block for these terms and B on `device`: enough that the grid
// is about one wave of resident blocks.
int pair_tiles_per_block(const PairTerm* terms, int n_terms, int B,
                         int device) {
  const int W = B < PAIR_THREADS ? B : PAIR_THREADS;
  const long long tile = (long long)(PAIR_THREADS / W) * PAIR_ELEMS;
  long long tiles = 0;
  for (int t = 0; t < n_terms; ++t) tiles += (terms[t].P + tile - 1) / tile;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess || sms <= 0)
    sms = 1;
  const long long slots = (long long)sms * PAIR_BLOCKS_PER_SM;
  return (int)((tiles + slots - 1) / slots);
}

// Blocks and groups of the pair entry for these terms, B and tiles per
// block; fills block0 and group0 (first block and group of each term, then
// the end for every unused slot) when given. Returns the number of blocks.
long long pair_blocks(const PairTerm* terms, int n_terms, int B, int nit,
                      int* block0, int* group0, long long* n_groups) {
  const int W = B < PAIR_THREADS ? B : PAIR_THREADS;
  const long long per_block = (long long)(PAIR_THREADS / W) * PAIR_ELEMS * nit;
  long long n = 0, g = 0;
  for (int t = 0; t < n_terms; ++t) {
    if (block0) block0[t] = (int)n;
    if (group0) group0[t] = (int)g;
    const long long nb = (terms[t].P + per_block - 1) / per_block;
    n += nb;
    g += (nb + GROUP - 1) / GROUP;
  }
  for (int t = n_terms; t <= MAX_TERMS; ++t) {
    if (block0) block0[t] = (int)n;
    if (group0) group0[t] = (int)g;
  }
  if (n_groups) *n_groups = g;
  return n;
}

// Sizes for these terms and B on `device`: the float32 work buffer (sums
// (n_terms, B), each term's deriv (P_t, B), the (n_blocks, B) and
// (n_groups, B) partials) and, in *counters, the unsigned ints of the
// launch's counters; -1 where the terms or B are out of range. `lanes`
// adds the interval tables' checks: a row map, U >= 1, a 16-byte aligned
// table and P*U*(K-1)*4 < 2^31.
long long pairs_buffer(const PairTerm* terms, int n_terms, int B, int device,
                       long long* counters, bool lanes) {
  if (n_terms < 1 || n_terms > MAX_TERMS || B <= 0 ||
      (B + PAIR_THREADS - 1) / PAIR_THREADS > 65535)
    return -1;
  long long n = (long long)n_terms * B;
  for (int t = 0; t < n_terms; ++t) {
    const PairTerm& tt = terms[t];
    if (tt.P <= 0 || tt.K < 2 || tt.K > MAX_K || tt.P * B >= 0x7fffffffLL ||
        tt.P * MAX_K >= 0x7fffffffLL)
      return -1;
    if (lanes && (tt.row == nullptr || tt.U < 1 ||
                  reinterpret_cast<uintptr_t>(tt.y) % 16 != 0 ||
                  tt.P * tt.U * (tt.K - 1) * 4 >= 0x7fffffffLL))
      return -1;
    n += tt.P * B;
  }
  long long groups = 0;
  const int nit = pair_tiles_per_block(terms, n_terms, B, device);
  const long long blocks =
      pair_blocks(terms, n_terms, B, nit, nullptr, nullptr, &groups);
  if (blocks > 0x7fffffffLL) return -1;
  const long long W = B < PAIR_THREADS ? B : PAIR_THREADS;
  if (counters) *counters = ((B + W - 1) / W) * (1 + groups);
  return n + (blocks + groups) * B;
}

int pairs_launch(const PairTerm* terms, int n_terms, const float* const* q,
                 int B, float* buf, unsigned int* counter, int device,
                 void* stream, bool lanes) {
  if (pairs_buffer(terms, n_terms, B, device, nullptr, lanes) < 0)
    return (int)cudaErrorInvalidValue;
  PairLaunch a{};
  a.n_terms = n_terms;
  a.B = B;
  a.W = B < PAIR_THREADS ? B : PAIR_THREADS;
  a.R = PAIR_THREADS / a.W;
  a.nit = pair_tiles_per_block(terms, n_terms, B, device);
  long long groups = 0;
  const int blocks = (int)pair_blocks(terms, n_terms, B, a.nit, a.block0,
                                      a.group0, &groups);
  a.sums = buf;
  float* next = buf + (long long)n_terms * B;
  for (int t = 0; t < n_terms; ++t) {
    a.y[t] = terms[t].y;
    a.m[t] = terms[t].m;
    a.x[t] = terms[t].x;
    a.act[t] = terms[t].act;
    a.row[t] = terms[t].row;
    a.P[t] = terms[t].P;
    a.K[t] = terms[t].K;
    a.U[t] = terms[t].U;
    a.q[t] = q[t];
    a.deriv[t] = next;
    next += terms[t].P * B;
  }
  a.partial = next;
  a.gpartial = next + (long long)blocks * B;
  a.counter = counter;
  int current = 0;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  const dim3 grid(blocks, (B + a.W - 1) / a.W);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes)
    spline_pairs_kernel<true><<<grid, PAIR_THREADS, 0, st>>>(a);
  else
    spline_pairs_kernel<false><<<grid, PAIR_THREADS, 0, st>>>(a);
  const int err = (int)cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return err;
}

// ---------------------------------------------------------------- dense

struct DenseLaunch {       // the kernel's parameter block, passed by value
  const float* y[MAX_TERMS];     // (P, K_t), 16-byte aligned
  const float* m[MAX_TERMS];
  const float* x[MAX_TERMS];
  const uint8_t* mask[MAX_TERMS];  // (P,)
  const float* q[MAX_TERMS];     // (B, P)
  float* deriv[MAX_TERMS];       // (B, P)
  int K[MAX_TERMS];
  int block0[MAX_TERMS + 1];     // first x-block of each term; unused = end
  int group0[MAX_TERMS + 1];     // first group of each term; unused = end
  int P;                         // pairs of every term, L*L
  int n_terms;
  int B;
  int chunk;                     // decoys per y-block, a multiple of
                                 // DENSE_BATCH
  float* partial;                // (gridDim.x, B) per block
  float* gpartial;               // (n_groups, B) per group
  float* sums;                   // (n_terms, B)
  unsigned int* counter;         // as PairLaunch's
};

__global__ void __launch_bounds__(DENSE_THREADS, DENSE_BLOCKS_PER_SM)
spline_dense_kernel(const DenseLaunch a) {
  extern __shared__ float2 rows[];   // (y[k], m[k]): DENSE_TILE rows of K|1
  __shared__ float xs[MAX_K];        // knots, +inf past K
  __shared__ float4 iv[MAX_K];       // per interval k: x[k], 1/h, h/6, h*h/6
  __shared__ float red[2][DENSE_BATCH][DENSE_WARPS];
  __shared__ bool on_s[DENSE_TILE];
  __shared__ bool is_last;

  const int bx = blockIdx.x;
  const int ti = (bx >= a.block0[1]) + (bx >= a.block0[2]) +
                 (bx >= a.block0[3]);           // this block's term, uniform
  const int K = pick(a.K, ti);
  const int S = K | 1;                          // odd row stride
  const int P = a.P, B = a.B;
  const int tid = threadIdx.x;
  const int b0 = pick(a.block0, ti);
  const int p0 = (bx - b0) * DENSE_TILE;
  const int np = min(DENSE_TILE, P - p0);       // pairs of this tile
  if (tid < MAX_K) {
    const float* xg = pick(a.x, ti);
    const float xa = tid < K ? xg[tid] : INFINITY;
    xs[tid] = xa;
    if (tid < K - 1) {
      const float h = xg[tid + 1] - xa;
      iv[tid] = make_float4(xa, 1.f / h, h / 6.f, h * h / 6.f);
    }
  }
  if (tid < DENSE_TILE) on_s[tid] = tid < np && pick(a.mask, ti)[p0 + tid];
  __syncthreads();

  const int pl = tid % DENSE_TILE;
  const int ln = tid / DENSE_TILE;              // decoy lane
  const bool in = pl < np;
  const bool on = on_s[pl];
  const int p = p0 + pl;
  const float* __restrict__ q = pick(a.q, ti);
  const int c0 = blockIdx.y * a.chunk;
  const int c1 = min(c0 + a.chunk, B);
  float qn[DENSE_ELEMS];          // the next step's queries: the first
#pragma unroll                    // step's are loaded beside the tables
  for (int e = 0; e < DENSE_ELEMS; ++e) {
    const int b = c0 + ln + DENSE_LANES * e;
    qn[e] = on && b < c1 ? q[b * P + p] : 0.f;
  }

  // the tile's table rows: 16-byte loads of the contiguous (np, K) blocks
  // of y and m (p0 * K is a multiple of 4), those touching no active pair
  // skipped; a thread starts DENSE_COPY loads of each before it stores any
  {
    const float* yg = pick(a.y, ti) + p0 * K;
    const float* mg = pick(a.m, ti) + p0 * K;
    const int n = np * K;
    for (int f0 = tid; 4 * f0 < n; f0 += DENSE_COPY * DENSE_THREADS) {
      float4 vy[DENSE_COPY], vm[DENSE_COPY];
      int pa[DENSE_COPY];                // first pair of each, -1: skipped
#pragma unroll
      for (int c = 0; c < DENSE_COPY; ++c) {
        const int e = 4 * (f0 + c * DENSE_THREADS);
        pa[c] = -1;
        if (e < n) {
          const int p1 = e / K, p2 = min(e + 3, n - 1) / K;
          if (on_s[p1] || on_s[p2] || p2 > p1 + 1) pa[c] = p1;
        }
        if (pa[c] >= 0 && e + 3 < n) {
          vy[c] = __ldg(reinterpret_cast<const float4*>(yg + e));
          vm[c] = __ldg(reinterpret_cast<const float4*>(mg + e));
        } else if (pa[c] >= 0) {          // the ragged end: scalars
          vy[c] = make_float4(yg[e], e + 1 < n ? yg[e + 1] : 0.f,
                              e + 2 < n ? yg[e + 2] : 0.f, 0.f);
          vm[c] = make_float4(mg[e], e + 1 < n ? mg[e + 1] : 0.f,
                              e + 2 < n ? mg[e + 2] : 0.f, 0.f);
        }
      }
#pragma unroll
      for (int c = 0; c < DENSE_COPY; ++c) {
        if (pa[c] < 0) continue;
        const int e = 4 * (f0 + c * DENSE_THREADS);
        const float yv[4] = {vy[c].x, vy[c].y, vy[c].z, vy[c].w};
        const float mv[4] = {vm[c].x, vm[c].y, vm[c].z, vm[c].w};
        int pp = pa[c], kk = e - pp * K;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (e + j < n) rows[pp * S + kk] = make_float2(yv[j], mv[j]);
          if (++kk == K) {
            kk = 0;
            ++pp;
          }
        }
      }
    }
  }
  __syncthreads();

  const int lane = tid & 31;
  const int wl = (tid >> 5) % DENSE_WARPS;      // warp within its lane
  float* __restrict__ deriv = pick(a.deriv, ti);
  const float2* row = rows + pl * S;
  const float x0 = xs[0], xl = xs[K - 1];

  // the decoy walk, its knot search unrolled for this term's K
  auto walk = [&](auto top) {
    constexpr int TOP = decltype(top)::value;
    int step = 0;
    for (int bb = c0; bb < c1; bb += DENSE_BATCH, ++step) {
      float qv[DENSE_ELEMS];
#pragma unroll
      for (int e = 0; e < DENSE_ELEMS; ++e) {     // this step's; the next
        qv[e] = qn[e];                            // step's loads start here
        const int b = bb + DENSE_BATCH + ln + DENSE_LANES * e;
        qn[e] = on && b < c1 ? q[b * P + p] : 0.f;
      }
      float v[DENSE_ELEMS];
#pragma unroll
      for (int e = 0; e < DENSE_ELEMS; ++e) {
        const int b = bb + ln + DENSE_LANES * e;
        const float qq = qv[e];
        const int kk = min(max(count_le<TOP>(xs, qq) - 1, 0), K - 2);
        const float4 c = iv[kk];                // x[k], 1/h, h/6, h*h/6
        const float2 lo = row[kk], hi = row[kk + 1];   // (y, m) at k, k+1
        float t = (qq - c.x) * c.y;
        t = t < 0.f ? 0.f : t > 1.f ? 1.f : t;    // a NaN stays NaN
        const float u = 1.f - t;
        const float d = (hi.x - lo.x) * c.y +
                        c.z * (-(3.f * u * u - 1.f) * lo.y +
                               (3.f * t * t - 1.f) * hi.y);
        // the distance past the end knots: 0 inside, NaN for a NaN
        const float off = qq - fminf(fmaxf(qq, x0), xl);
        const float val = u * lo.x + t * hi.x +
                          (u * u * u - u) * c.w * lo.y +
                          (t * t * t - t) * c.w * hi.y + d * off;
        const bool live = on && b < c1;           // never evaluated: 0, 0
        v[e] = live ? val : 0.f;
        if (in && b < c1) deriv[b * P + p] = live ? d : 0.f;
      }
      // reduce-scatter over the warp: lane ends with decoy e = lane >> 3
      const unsigned full = 0xffffffffu;
      const bool h16 = lane & 16, h8 = lane & 8;
      const float w0 = (h16 ? v[2] : v[0]) +
                       __shfl_xor_sync(full, h16 ? v[0] : v[2], 16);
      const float w1 = (h16 ? v[3] : v[1]) +
                       __shfl_xor_sync(full, h16 ? v[1] : v[3], 16);
      float w = (h8 ? w1 : w0) + __shfl_xor_sync(full, h8 ? w0 : w1, 8);
      w += __shfl_xor_sync(full, w, 4);
      w += __shfl_xor_sync(full, w, 2);
      w += __shfl_xor_sync(full, w, 1);
      if ((lane & 7) == 0)
        red[step & 1][ln + DENSE_LANES * (lane >> 3)][wl] = w;
      __syncthreads();           // red[step & 1] is read before step + 2
      if (tid < DENSE_BATCH && bb + tid < c1) {
        float s = 0.f;
#pragma unroll
        for (int u = 0; u < DENSE_WARPS; ++u) s += red[step & 1][tid][u];
        a.partial[(long long)bx * B + bb + tid] = s;
      }
    }
  };
  const int top = K - 1 >= 32 ? 32 : K - 1 >= 16 ? 16 : K - 1 >= 8 ? 8
                : K - 1 >= 4 ? 4 : K - 1 >= 2 ? 2 : 1;   // uniform
  if (top == 32) walk(Int<32>());
  else if (top == 16) walk(Int<16>());
  else if (top == 8) walk(Int<8>());
  else if (top == 4) walk(Int<4>());
  else if (top == 2) walk(Int<2>());
  else walk(Int<1>());

  // first level: the last block of this group sums its partials
  const int n_groups = a.group0[MAX_TERMS];
  const int gl = (bx - b0) / GROUP;
  const int grp = pick(a.group0, ti) + gl;
  const int gb0 = b0 + gl * GROUP;
  const int b1 = ti == 0 ? a.block0[1] : ti == 1 ? a.block0[2]
               : ti == 2 ? a.block0[3] : a.block0[4];   // this term's end
  const int gend = min(gb0 + GROUP, b1);
  unsigned int* group_counter =
      a.counter + gridDim.y + blockIdx.y * n_groups + grp;
  if (!arrive_last(group_counter, gend - gb0, &is_last)) return;
  for (int b = c0 + tid; b < c1; b += DENSE_THREADS)
    a.gpartial[(long long)grp * B + b] =
        strided_sum(a.partial, gb0, gend, 1, B, b, true);

  // second level: the last group sums every term's group partials
  if (!arrive_last(a.counter + blockIdx.y, n_groups, &is_last)) return;
  for (int b = c0 + tid; b < c1; b += DENSE_THREADS)
    for (int u = 0; u < a.n_terms; ++u)
      a.sums[(long long)u * B + b] =
          strided_sum(a.gpartial, a.group0[u], a.group0[u + 1], 1, B, b,
                      true);
}

// The dense entry's grid for these terms and B on `device`: fills the
// launch's block0, group0 and chunk when given; returns the number of
// x-blocks (n_terms tiles of P pairs), *groups and *chunks (y-blocks), or
// -1 where the terms or B are out of range: 1..MAX_TERMS terms of one P,
// 2 <= K <= MAX_K, 16-byte aligned tables, B * P and P * K below 2^31.
long long dense_grid(const PairTerm* terms, int n_terms, int B, int device,
                     DenseLaunch* a, long long* groups, long long* chunks) {
  if (n_terms < 1 || n_terms > MAX_TERMS || B <= 0) return -1;
  const long long P = terms[0].P;
  for (int t = 0; t < n_terms; ++t) {
    const PairTerm& tt = terms[t];
    if (tt.P != P || P <= 0 || tt.K < 2 || tt.K > MAX_K ||
        P * B >= 0x7fffffffLL || P * MAX_K >= 0x7fffffffLL ||
        reinterpret_cast<uintptr_t>(tt.y) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(tt.m) % 16 != 0)
      return -1;
  }
  const long long tiles = (P + DENSE_TILE - 1) / DENSE_TILE;
  const long long per_term = (tiles + GROUP - 1) / GROUP;
  const long long blocks = tiles * n_terms;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess || sms <= 0)
    sms = 1;
  // split the decoys only as far as the tiles leave resident slots empty
  const long long slots = (long long)sms * DENSE_BLOCKS_PER_SM;
  const long long steps = (B + DENSE_BATCH - 1) / DENSE_BATCH;
  long long split = slots / blocks;
  split = split < 1 ? 1 : split > steps ? steps : split;
  const long long chunk = (steps + split - 1) / split * DENSE_BATCH;
  const long long n_chunks = (B + chunk - 1) / chunk;
  if (blocks > 0x7fffffffLL || n_chunks > 65535) return -1;
  if (a) {
    for (int t = 0; t <= MAX_TERMS; ++t) {
      const int u = t < n_terms ? t : n_terms;
      a->block0[t] = (int)(tiles * u);
      a->group0[t] = (int)(per_term * u);
    }
    a->chunk = (int)chunk;
  }
  if (groups) *groups = per_term * n_terms;
  if (chunks) *chunks = n_chunks;
  return blocks;
}

// Sizes for these terms and B: the float32 work buffer (sums (n_terms, B),
// each term's deriv (B, P), the (n_blocks, B) and (n_groups, B) partials)
// and, in *counters, the launch's counters; -1 where out of range.
long long dense_buffer(const PairTerm* terms, int n_terms, int B,
                       int device, long long* counters) {
  long long groups = 0, chunks = 0;
  const long long blocks =
      dense_grid(terms, n_terms, B, device, nullptr, &groups, &chunks);
  if (blocks < 0) return -1;
  if (counters) *counters = chunks * (1 + groups);
  return (long long)n_terms * B * (1 + terms[0].P) + (blocks + groups) * B;
}

int dense_launch(const PairTerm* terms, int n_terms, const float* const* q,
                 int B, float* buf, unsigned int* counter, int device,
                 void* stream) {
  DenseLaunch a{};
  long long groups = 0, chunks = 0;
  const long long blocks =
      dense_grid(terms, n_terms, B, device, &a, &groups, &chunks);
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  int kmax = 0;
  a.n_terms = n_terms;
  a.B = B;
  a.P = (int)terms[0].P;
  a.sums = buf;
  float* next = buf + (long long)n_terms * B;
  for (int t = 0; t < n_terms; ++t) {
    a.y[t] = terms[t].y;
    a.m[t] = terms[t].m;
    a.x[t] = terms[t].x;
    a.mask[t] = terms[t].act;
    a.K[t] = terms[t].K;
    a.q[t] = q[t];
    a.deriv[t] = next;
    next += terms[t].P * B;
    kmax = terms[t].K > kmax ? terms[t].K : kmax;
  }
  a.partial = next;
  a.gpartial = next + blocks * B;
  a.counter = counter;
  int current = 0;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  const size_t smem = sizeof(float2) * DENSE_TILE * (kmax | 1);
  int err = 0;
  if (smem > 48 * 1024)      // above the default only after opting in
    err = (int)cudaFuncSetAttribute(
        spline_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
  if (err == 0) {
    spline_dense_kernel<<<dim3((unsigned)blocks, (unsigned)chunks),
                          DENSE_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
    err = (int)cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return err;
}

}  // namespace

// Plain C entry points, bound from Python with ctypes. All float tensors
// are contiguous float32, masks are one byte per element (torch.bool).
// Each launch returns cudaGetLastError() after the launch.

// The pair entry's sizes (pairs_buffer) for shared (P_t, K_t) tables.
extern "C" long long trx2dy_spline_pairs_buffer(const PairTerm* terms,
                                                int n_terms, int B,
                                                int device,
                                                long long* counters) {
  return pairs_buffer(terms, n_terms, B, device, counters, false);
}

// One launch for n_terms terms (stage constants in `terms`, host memory)
// and their queries q[t] (P_t, B) into `buf`, laid out as
// trx2dy_spline_pairs_buffer says. `counter` holds the unsigned ints it
// says, 0 before the launch and 0 again after it; launches that share
// counters must run on one stream. Runs on `device`; the caller's current
// device is current again after.
extern "C" int trx2dy_spline_pairs(const PairTerm* terms, int n_terms,
                                   const float* const* q, int B, float* buf,
                                   unsigned int* counter, int device,
                                   void* stream) {
  return pairs_launch(terms, n_terms, q, B, buf, counter, device, stream,
                      false);
}

// The lanes entry: as the pair entry, with each term's interval table
// (P_t, U_t, K_t - 1, 4) in y, its lane -> row map (B,) in row, U_t in U
// and activity (P_t, B) in `terms`.
extern "C" long long trx2dy_spline_lanes_buffer(const PairTerm* terms,
                                                int n_terms, int B,
                                                int device,
                                                long long* counters) {
  return pairs_buffer(terms, n_terms, B, device, counters, true);
}

extern "C" int trx2dy_spline_lanes(const PairTerm* terms, int n_terms,
                                   const float* const* q, int B, float* buf,
                                   unsigned int* counter, int device,
                                   void* stream) {
  return pairs_launch(terms, n_terms, q, B, buf, counter, device, stream,
                      true);
}

// The dense entry: up to four terms of shared (L*L, K_t) tables, each
// term's y, m (16-byte aligned), x, mask (L*L) in `terms` (act = mask,
// P = L*L, row null), queries q[t] (B, L*L). Sizes as for the pair entry:
// the work buffer holds the sums (n_terms, B), then each term's deriv
// (B, L*L), then the kernel's partials.
extern "C" long long trx2dy_spline_dense_buffer(const PairTerm* terms,
                                                int n_terms, int B,
                                                int device,
                                                long long* counters) {
  return dense_buffer(terms, n_terms, B, device, counters);
}

extern "C" int trx2dy_spline_dense(const PairTerm* terms, int n_terms,
                                   const float* const* q, int B, float* buf,
                                   unsigned int* counter, int device,
                                   void* stream) {
  return dense_launch(terms, n_terms, q, B, buf, counter, device, stream);
}

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
//   dense  y, m (L*L, K), q (B, L*L), mask (L*L)  -> the TPU kernel's layout,
//          one term per launch; the caller sums the (B, n_blocks) partials.
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
// rows), about 13 us at 3.35 TB/s. The lanes entry moves q, act and deriv
// per (pair, lane), 9 bytes, and 16 bytes per distinct (pair, row,
// interval) its active queries touch: at a full L=150 union with B=32 that
// is ~10-40 MB by the lane map, 3-12 us; at L=64 under 3 us, where the
// launch's latency chain (activity and query, interval search, table
// load, derivative store, two fenced rendezvous for the sums) and not the
// bytes is what it waits on.
//
// Dense design: knots go to shared memory once per block; each thread finds
// its interval by binary search over at most 64 knots (not the TPU kernel's
// masked scan over all K-1 intervals) and reads the four table values from
// the K-contiguous row; each block writes one fixed-order partial per decoy.
//
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
// table row; the pair entry leaves row null and U 0.
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

// dense entry: one thread per pair, DENSE_DECOYS decoys per block
constexpr int DENSE_THREADS = 256;
constexpr int DENSE_DECOYS = 8;
// pair entry: PAIR_THREADS threads per block, PAIR_ELEMS pairs per thread,
// GROUP blocks per first-level sum
constexpr int PAIR_THREADS = 256;
constexpr int PAIR_ELEMS = 4;
constexpr int MAX_TERMS = 4;
constexpr int GROUP = 64;
constexpr int PAIR_BLOCKS_PER_SM = 4;   // resident blocks the grid aims at
constexpr int SUM_LOADS = 16;   // partials a thread loads at once when summing

__device__ __forceinline__ void spline_at(const float* __restrict__ xs, int K,
                                          const float* __restrict__ y,
                                          const float* __restrict__ m,
                                          float q, float& val, float& der) {
  const float x0 = xs[0];
  const float xl = xs[K - 1];
  if (q < x0) {
    const float h0 = xs[1] - x0;
    const float y0 = y[0];
    const float s = (y[1] - y0) / h0 - h0 * (2.f * m[0] + m[1]) / 6.f;
    val = y0 + s * (q - x0);
    der = s;
    return;
  }
  if (q > xl) {
    const float hn = xl - xs[K - 2];
    const float yl = y[K - 1];
    const float s = (yl - y[K - 2]) / hn + hn * (m[K - 2] + 2.f * m[K - 1]) / 6.f;
    val = yl + s * (q - xl);
    der = s;
    return;
  }
  // count = #{xs[0 .. K-2] <= q}, by binary search (a NaN q counts 0)
  int lo = 0, hi = K - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (xs[mid] <= q) lo = mid + 1; else hi = mid;
  }
  const int k = min(max(lo - 1, 0), K - 2);
  const float xa = xs[k];
  const float h = xs[k + 1] - xa;
  const float ya = y[k], yb = y[k + 1], ma = m[k], mb = m[k + 1];
  const float t = (q - xa) / h;
  const float u = 1.f - t;
  const float h2 = h * h / 6.f;
  val = u * ya + t * yb + (u * u * u - u) * h2 * ma + (t * t * t - t) * h2 * mb;
  der = (yb - ya) / h +
        h / 6.f * (-(3.f * u * u - 1.f) * ma + (3.f * t * t - 1.f) * mb);
}

__global__ void __launch_bounds__(DENSE_THREADS)
spline_dense_kernel(const float* __restrict__ y, const float* __restrict__ m,
                    const float* __restrict__ x, int K,
                    const float* __restrict__ q,
                    const uint8_t* __restrict__ mask, long long n_pairs, int B,
                    float* __restrict__ partial, float* __restrict__ deriv) {
  __shared__ float xs[MAX_K];
  __shared__ float red[DENSE_DECOYS][DENSE_THREADS / 32];
  for (int i = threadIdx.x; i < K; i += DENSE_THREADS) xs[i] = x[i];
  __syncthreads();

  const long long p = (long long)blockIdx.x * DENSE_THREADS + threadIdx.x;
  const bool on = p < n_pairs && mask[p] != 0;
  const float* yr = y + p * K;
  const float* mr = m + p * K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * DENSE_DECOYS;

  for (int bl = 0; bl < DENSE_DECOYS; ++bl) {
    const int b = b0 + bl;                 // uniform over the block
    float v = 0.f;
    if (b < B && p < n_pairs) {
      float d = 0.f;   // a masked element is never evaluated: 0, 0
      if (on) spline_at(xs, K, yr, mr, q[(long long)b * n_pairs + p], v, d);
      deriv[(long long)b * n_pairs + p] = d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[bl][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < DENSE_DECOYS) {
    const int b = b0 + threadIdx.x;
    if (b < B) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < DENSE_THREADS / 32; ++w) s += red[threadIdx.x][w];
      partial[(long long)b * gridDim.x + blockIdx.x] = s;
    }
  }
}

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
// as the TPU kernel's count over x[:K-1] does.
__device__ __forceinline__ int count_le(const float* __restrict__ xs, float q) {
  int pos = 0;
#pragma unroll
  for (int s = 32; s > 0; s >>= 1) pos += (xs[pos + s - 1] <= q) ? s : 0;
  return pos;
}

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

}  // namespace

// Plain C entry points, bound from Python with ctypes. All float tensors
// are contiguous float32, masks are one byte per element (torch.bool).
// Each launch returns cudaGetLastError() after the launch.

extern "C" int trx2dy_spline_dense_blocks(long long n_pairs) {
  return (int)((n_pairs + DENSE_THREADS - 1) / DENSE_THREADS);
}

// `n_blocks` is the caller's width of the (B, n_blocks) partial buffer and
// must equal the kernel's block count.
extern "C" int trx2dy_spline_dense(const float* y, const float* m,
                                   const float* x, int K, const float* q,
                                   const uint8_t* mask, long long n_pairs,
                                   int B, float* partial, int n_blocks,
                                   float* deriv, void* stream) {
  if (K < 2 || K > MAX_K || B <= 0 || n_pairs <= 0 ||
      n_blocks != trx2dy_spline_dense_blocks(n_pairs) ||
      (B + DENSE_DECOYS - 1) / DENSE_DECOYS > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_blocks, (B + DENSE_DECOYS - 1) / DENSE_DECOYS);
  spline_dense_kernel<<<grid, DENSE_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      y, m, x, K, q, mask, n_pairs, B, partial, deriv);
  return (int)cudaGetLastError();
}

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

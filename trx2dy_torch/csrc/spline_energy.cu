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
// Two entry points share the device function spline_at:
//   dense  y, m (L*L, K), q (B, L*L), mask (L*L)  -> the TPU kernel's layout;
//   pairs  y, m (P, K),   q (P, B),   act (P)     -> the compacted pair lists
//          the production fold evaluates (trx2dy/physics/spline.py:
//          _eval_with_deriv_pb via compact.compact_restraint_energy_batch).
//
// What bounds it on an H100: per query it reads q and 4 table values and
// writes one derivative, with ~40 flops, far below the 67 TFLOP/s f32 rate,
// so it is bound by bytes. At the fold's sizes (L=150, B=50) one call moves
// at most ~15 MB, about 5 us at 3.35 TB/s, so in practice each launch is
// set by launch latency. The design therefore keeps each call to one
// launch with no atomics and no second pass in the kernel: knots go to
// shared memory once per block; each thread finds its interval directly by
// binary search over at most 64 knots (not the TPU kernel's masked scan
// over all K-1 intervals) and reads the four table values from the
// K-contiguous row; in the pair entry the 32 decoys of a warp share one
// pair's row, so those reads are broadcasts. A masked element is never
// evaluated and gives 0 and 0, so an inf or NaN there never leaks (the
// plain version selects, with the same result). The per-decoy sum is
// deterministic: each block reduces in a fixed order and writes one partial
// per decoy into a (B, n_blocks) buffer that the caller sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 64;

// dense entry: one thread per pair, DENSE_DECOYS decoys per block
constexpr int DENSE_THREADS = 256;
constexpr int DENSE_DECOYS = 8;
// pair entry: a (PAIR_LANES decoys) x (PAIR_ROWS) thread block walks
// PAIRS_PER_BLOCK pairs
constexpr int PAIR_LANES = 32;
constexpr int PAIR_ROWS = 8;
constexpr int PAIRS_PER_BLOCK = 64;

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

__global__ void __launch_bounds__(PAIR_LANES * PAIR_ROWS)
spline_pairs_kernel(const float* __restrict__ y, const float* __restrict__ m,
                    const float* __restrict__ x, int K,
                    const float* __restrict__ q,
                    const uint8_t* __restrict__ act, int P, int B,
                    float* __restrict__ partial, float* __restrict__ deriv) {
  __shared__ float xs[MAX_K];
  __shared__ float red[PAIR_ROWS][PAIR_LANES];
  const int tid = threadIdx.y * PAIR_LANES + threadIdx.x;
  for (int i = tid; i < K; i += PAIR_LANES * PAIR_ROWS) xs[i] = x[i];
  __syncthreads();

  const int b = blockIdx.x * PAIR_LANES + threadIdx.x;
  const int p0 = blockIdx.y * PAIRS_PER_BLOCK;
  float acc = 0.f;
  if (b < B) {
    for (int pp = threadIdx.y; pp < PAIRS_PER_BLOCK; pp += PAIR_ROWS) {
      const int p = p0 + pp;
      if (p >= P) break;
      const long long e = (long long)p * B + b;
      float v = 0.f, d = 0.f;   // an inactive pair is never evaluated
      if (act[p]) spline_at(xs, K, y + (long long)p * K, m + (long long)p * K,
                            q[e], v, d);
      acc += v;
      deriv[e] = d;
    }
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && b < B) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < PAIR_ROWS; ++r) s += red[r][threadIdx.x];
    partial[(long long)b * gridDim.y + blockIdx.y] = s;
  }
}

}  // namespace

// Plain C entry points, bound from Python with ctypes. All float tensors
// are contiguous float32, masks are one byte per element (torch.bool).
// `n_blocks` is the caller's width of the (B, n_blocks) partial buffer and
// must equal the kernel's block count. Each returns cudaGetLastError()
// after the launch.

extern "C" int trx2dy_spline_dense_blocks(long long n_pairs) {
  return (int)((n_pairs + DENSE_THREADS - 1) / DENSE_THREADS);
}

extern "C" int trx2dy_spline_pairs_blocks(int P) {
  return (P + PAIRS_PER_BLOCK - 1) / PAIRS_PER_BLOCK;
}

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

extern "C" int trx2dy_spline_pairs(const float* y, const float* m,
                                   const float* x, int K, const float* q,
                                   const uint8_t* act, int P, int B,
                                   float* partial, int n_blocks, float* deriv,
                                   void* stream) {
  if (K < 2 || K > MAX_K || B <= 0 || P <= 0 ||
      n_blocks != trx2dy_spline_pairs_blocks(P) || n_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + PAIR_LANES - 1) / PAIR_LANES, n_blocks);
  const dim3 block(PAIR_LANES, PAIR_ROWS);
  spline_pairs_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      y, m, x, K, q, act, P, B, partial, deriv);
  return (int)cudaGetLastError();
}

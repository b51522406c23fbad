// Triangle attention core, forward, float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel trx2dy/ops/triangle_attention.py:
// _tri_attn_kernel (launched by triangle_attention_flash). For row r,
// query i and head h it computes
//
//   out[r,i,h,:] = sum_j softmax_j( q[r,i,h,:].k[r,j,h,:] / sqrt(D)
//                                   + bias[i,j,h] ) v[r,j,h,:]
//
// with an online softmax over key tiles, so the (L, L, L, H) logits never
// reach device memory. Column-wise attention is the same function with the
// row and position axes of q, k, v and out exchanged: the kernel takes a
// row stride and a position stride for every tensor, so the caller passes
// swapped strides and makes no transposed copy. The bias keeps its
// (query, key, head) meaning in both directions, with any strides.
//
// What bounds it on an H100: at L=400, H=4, D=32 one call does
// 4 L^3 H D = 32.8 GFLOP and moves about 328 MB of q, k, v and out
// (0.10 ms at 3.35 TB/s). In float32 outside the tensor cores (67 TFLOP/s)
// that is 0.49 ms, so it is bound by operations. The JAX code pins
// Precision.HIGHEST, so single-pass TF32 (10-bit mantissa, ~1e-3 relative)
// is not allowed; this kernel runs both products on the tensor cores as
// 3xTF32: every operand a is split into hi = tf32(a) and lo = tf32(a - hi),
// and a.b is accumulated in float32 as lo.hi + hi.lo + hi.hi, which drops
// only lo.lo and the rounding of lo (~3 * 2^-22 of |a.b|). Three TF32
// products cost 3 * 32.8 GFLOP / 495 TFLOP/s = 0.199 ms at the dense
// TF32 peak.
//
// Design (FlashAttention-2 on mma.sync.m16n8k8 TF32):
//  - one block of 4 warps per (query tile of BQ=64, head, row); each warp
//    owns 16 queries, and keeps their scaled, split q fragments, the
//    running max and sum and the 16 x 32 output in registers;
//  - K and V tiles of BK=32 keys come in by cp.async into a double-buffered
//    shared-memory ring, so the next tile's load overlaps this tile's
//    products; once landed, a tile is split into hi and lo once per block
//    (not once per warp) into shared arrays the warps read their fragments
//    from (row stride D+4 words: conflict-free). 32-key tiles keep a thread
//    at 128 registers, so 4 blocks (16 warps) share an SM;
//  - the split is integer arithmetic: hi = (bits + 0x1000) & ~0x1fff is
//    cvt.rna.tf32.f32's round-to-nearest, ties away, without the convert;
//  - the tensor cores truncate their float32 accumulator at each mma, so a
//    chain of accumulations drifts: every product of a tile gets fresh
//    accumulators, the hi.hi terms apart from the 2^-11 smaller ones, and
//    tiles are added to the running output with round-to-nearest FMAs;
//  - the softmax runs in float32 registers in base 2 (log2(e) is folded
//    into the q scale and the bias). P never leaves registers: within each
//    8-key step the keys are taken in the order (0, 2, 4, 6, 1, 3, 5, 7),
//    so the accumulator layout of S is the A-operand layout of P, and V's
//    rows are read in the same order (the sum over keys does not depend on
//    their order);
//  - each thread reads its bias values straight from global memory. The
//    trunk stores the bias head-major ((H, L, L) viewed as (L, L, H)), so a
//    head's tile is contiguous.
// The ragged L edge is masked in the kernel: keys past L are zero-filled
// and score -inf, queries past L load zeros and store nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 32;             // head width of the trunk (dim 128 / 4 heads)
constexpr int BQ = 64;            // queries per block
constexpr int BK = 32;            // keys per shared-memory tile
constexpr int WARPS = BQ / 16;    // 16 queries per warp
constexpr int THREADS = 32 * WARPS;
constexpr int SROW = D + 4;       // shared row stride, words
constexpr int CHUNKS = BK * D / 4 / THREADS;   // 16-byte copies per thread
constexpr int TILE = BK * SROW;   // words of one (BK, D) tile
// dynamic shared memory: raw K, V for two stages, then K hi, K lo, V hi, V lo
constexpr int SMEM_BYTES = (2 * 2 + 4) * TILE * 4;

// x rounded to TF32 (10 mantissa bits, nearest, ties away from zero), as
// cvt.rna.tf32.f32 rounds it, and the rounded remainder x - hi
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// c += a.b, m16n8k8, A row-major (16 x 8), B column-major (8 x 8); not
// volatile, so independent products may be interleaved
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;   // 0: nothing is read, 16 zero bytes land
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS, 4)
tri_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int L, long long q_sr, long long q_sp, long long k_sr,
                    long long k_sp, long long v_sr, long long v_sp,
                    long long o_sr, long long o_sp, long long b_si,
                    long long b_sj, long long b_sh, float q_scale,
                    float b_scale) {
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                                   // [stage][K|V] tiles
  uint32_t* khi = reinterpret_cast<uint32_t*>(smem + 4 * TILE);
  uint32_t* klo = khi + TILE;
  uint32_t* vhi = klo + TILE;
  uint32_t* vlo = vhi + TILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;        // accumulator row group
  const int t = lane & 3;         // thread in the group
  const int h = blockIdx.y;
  const long long r = blockIdx.z;
  const int qa = blockIdx.x * BQ + warp * 16 + g;   // this thread's two rows
  const int qb = qa + 8;

  const float* kr = k + r * k_sr + h * D;
  const float* vr = v + r * v_sr + h * D;
  // one commit group per tile, empty past the last
  auto load_tile = [&](int kt) {
    const int j0 = kt * BK;
    float* ks = raw + (kt & 1) * 2 * TILE;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int e = tid + c * THREADS;
      const int jj = e / (D / 4);
      const int col = (e % (D / 4)) * 4;
      const int j = j0 + jj;
      if (j0 < L) {
        const bool ok = j < L;
        const long long jc = ok ? j : 0;
        cp_async16(ks + jj * SROW + col, kr + jc * k_sp + col, ok);
        cp_async16(ks + TILE + jj * SROW + col, vr + jc * v_sp + col, ok);
      }
    }
    cp_async_commit();
  };

  load_tile(0);
  load_tile(1);

  // q fragments, scaled by log2(e)/sqrt(D) and split once:
  // a0 (qa, d), a1 (qb, d), a2 (qa, d+4), a3 (qb, d+4), d = 8 ks + t
  uint32_t qhi[D / 8][4], qlo[D / 8][4];
  {
    const float* pa = q + r * q_sr + (long long)min(qa, L - 1) * q_sp + h * D;
    const float* pb = q + r * q_sr + (long long)min(qb, L - 1) * q_sp + h * D;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const int d = ks * 8 + t;
      const float x[4] = {qa < L ? pa[d] : 0.f, qb < L ? pb[d] : 0.f,
                          qa < L ? pa[d + 4] : 0.f, qb < L ? pb[d + 4] : 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) split(x[i] * q_scale, qhi[ks][i], qlo[ks][i]);
    }
  }

  float o[D / 8][4];              // (qa, 8 dn + 2t + {0,1}), (qb, ...)
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dn][i] = 0.f;
  float ma = -INFINITY, mb = -INFINITY;   // running max, base 2
  float la = 0.f, lb = 0.f;               // this thread's share of the sums

  const float* ba = bias + (long long)min(qa, L - 1) * b_si + h * b_sh;
  const float* bb = bias + (long long)min(qb, L - 1) * b_si + h * b_sh;
  const int n_tiles = (L + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int j0 = kt * BK;
    cp_async_wait1();              // this tile landed (the next may not)
    __syncthreads();               // ... for every thread; splits consumed
    {
      const float* src = raw + (kt & 1) * 2 * TILE;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int e = tid + c * THREADS;
        const int at = (e / (D / 4)) * SROW + (e % (D / 4)) * 4;
        const float4 kx = *reinterpret_cast<const float4*>(src + at);
        const float4 vx = *reinterpret_cast<const float4*>(src + TILE + at);
        uint4 h4, l4;
        split(kx.x, h4.x, l4.x);
        split(kx.y, h4.y, l4.y);
        split(kx.z, h4.z, l4.z);
        split(kx.w, h4.w, l4.w);
        *reinterpret_cast<uint4*>(khi + at) = h4;
        *reinterpret_cast<uint4*>(klo + at) = l4;
        split(vx.x, h4.x, l4.x);
        split(vx.y, h4.y, l4.y);
        split(vx.z, h4.z, l4.z);
        split(vx.w, h4.w, l4.w);
        *reinterpret_cast<uint4*>(vhi + at) = h4;
        *reinterpret_cast<uint4*>(vlo + at) = l4;
      }
    }
    __syncthreads();               // splits visible; this raw stage is free
    load_tile(kt + 2);

    // logits in base 2: s[nt] holds keys j0 + 8 nt + 2t + {0, 1} of rows
    // qa (0, 1) and qb (2, 3), as the mma accumulator does
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const int j = j0 + nt * 8 + 2 * t;
      const long long o0 = (long long)min(j, L - 1) * b_sj;
      const long long o1 = (long long)min(j + 1, L - 1) * b_sj;
      s[nt][0] = ba[o0];
      s[nt][1] = ba[o1];
      s[nt][2] = bb[o0];
      s[nt][3] = bb[o1];
    }
    float mxa = ma, mxb = mb;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
      const int row = (nt * 8 + g) * SROW;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        const int at = row + ks * 8 + t;
        const uint32_t h0 = khi[at], h1 = khi[at + 4];
        mma(small, qlo[ks], h0, h1);
        mma(small, qhi[ks], klo[at], klo[at + 4]);
        mma(big, qhi[ks], h0, h1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + nt * 8 + 2 * t + (i & 1);
        const float x = j < L ? fmaf(s[nt][i], b_scale, big[i] + small[i])
                              : -INFINITY;
        s[nt][i] = x;
        if (i < 2) mxa = fmaxf(mxa, x); else mxb = fmaxf(mxb, x);
      }
    }

    // online softmax over this tile, rows qa and qb
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {     // the 4 threads of a row group
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, w));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, w));
    }
    const float ca = exp2f(ma - mxa);     // 0 on the first tile
    const float cb = exp2f(mb - mxb);
    ma = mxa;
    mb = mxb;
    la *= ca;
    lb *= cb;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - ma);    // 0 for masked keys
      s[nt][1] = exp2f(s[nt][1] - ma);
      s[nt][2] = exp2f(s[nt][2] - mb);
      s[nt][3] = exp2f(s[nt][3] - mb);
      la += s[nt][0] + s[nt][1];
      lb += s[nt][2] + s[nt][3];
    }

    // this tile's P.V: 8-key step ks holds keys 8 ks + 2t (A column t) and
    // 8 ks + 2t + 1 (A column t + 4), so P's A operand is s[ks] as it is
    float big[D / 8][4], small[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int i = 0; i < 4; ++i) big[dn][i] = small[dn][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      uint32_t phi[4], plo[4];
      split(s[ks][0], phi[0], plo[0]);
      split(s[ks][2], phi[1], plo[1]);
      split(s[ks][1], phi[2], plo[2]);
      split(s[ks][3], phi[3], plo[3]);
      const int row = (ks * 8 + 2 * t) * SROW + g;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const int at = row + dn * 8;
        const uint32_t h0 = vhi[at], h1 = vhi[at + SROW];
        mma(small[dn], plo, h0, h1);
        mma(small[dn], phi, vlo[at], vlo[at + SROW]);
        mma(big[dn], phi, h0, h1);
      }
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] = fmaf(o[dn][0], ca, big[dn][0] + small[dn][0]);
      o[dn][1] = fmaf(o[dn][1], ca, big[dn][1] + small[dn][1]);
      o[dn][2] = fmaf(o[dn][2], cb, big[dn][2] + small[dn][2]);
      o[dn][3] = fmaf(o[dn][3], cb, big[dn][3] + small[dn][3]);
    }
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, w);
    lb += __shfl_xor_sync(0xffffffffu, lb, w);
  }
  const float ia = 1.f / la, ib = 1.f / lb;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int d = dn * 8 + 2 * t;
    if (qa < L)
      *reinterpret_cast<float2*>(out + r * o_sr + (long long)qa * o_sp +
                                 h * D + d) =
          make_float2(o[dn][0] * ia, o[dn][1] * ia);
    if (qb < L)
      *reinterpret_cast<float2*>(out + r * o_sr + (long long)qb * o_sp +
                                 h * D + d) =
          make_float2(o[dn][2] * ib, o[dn][3] * ib);
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. q, k, v and out are
// float32 with head stride D and unit element stride, 16-byte aligned per
// (row, position, head) vector; strides are in elements. q, k, v and out
// hold `rows` rows of L positions (the grid's z axis runs over the rows),
// the bias is (L, L, H): rows = L for the triangle attentions, the MSA's
// depth for the MSA row attention with pair bias. Returns
// cudaGetLastError() after the launch.
extern "C" int trx2dy_tri_attn_fwd(
    const float* q, const float* k, const float* v, const float* bias,
    float* out, int rows, int L, int H, int head_dim, long long q_sr,
    long long q_sp,
    long long k_sr, long long k_sp, long long v_sr, long long v_sp,
    long long o_sr, long long o_sp, long long b_si, long long b_sj,
    long long b_sh, void* stream) {
  if (rows <= 0 || L <= 0 || H <= 0 || rows > 65535 || H > 65535 ||
      L > 65535 || head_dim != D)
    return (int)cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      tri_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const double log2e = 1.4426950408889634;
  const dim3 grid((L + BQ - 1) / BQ, H, rows);
  tri_attn_fwd_kernel<<<grid, THREADS, SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      q, k, v, bias, out, L, q_sr, q_sp, k_sr, k_sp, v_sr, v_sp, o_sr, o_sp,
      b_si, b_sj, b_sh, (float)(log2e / sqrt((double)D)), (float)log2e);
  return (int)cudaGetLastError();
}

// Triangle attention core, forward, for Hopper (sm_90a): a kernel for
// float32 q, k, v (tri_attn_fwd_kernel, this note) and one for bf16 q, k, v
// (tri_attn_fwd_kernel_bf16, its note further down). Both compute the same
// float32 function and write float32.
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

#include <type_traits>

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

// 16 bytes to the shared-space byte address s
__device__ __forceinline__ void cp_async16_s(uint32_t s, const void* gmem,
                                             bool valid) {
  const int n = valid ? 16 : 0;   // 0: nothing is read, 16 zero bytes land
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  cp_async16_s(static_cast<uint32_t>(__cvta_generic_to_shared(smem)), gmem,
               valid);
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

// --------------------------------------------------------------------------
// bf16 operands (tri_attn_fwd_kernel_bf16). The bf16 models (AlphaFold2, the
// e2e predictor) make q, k, v and the bias with bf16 products; this kernel
// takes those values as they are (no float32 copies before the launch) and
// computes the float32 function above on them, float32 out. The bias may be
// bf16 or float32.
//
// What bounds it on an H100: at AlphaFold2's MSA-row launch, (R, L, H) =
// (512, 368, 8), the function is 4 R L^2 H D = 71 GFLOP and moves 0.48 GB
// (bf16 q, k, v, float32 out): 0.072 ms of bf16 products at the dense peak,
// 0.145 ms of bytes. This kernel runs 2.2x those products (P in three
// terms, below) on mma.sync and, per score, about 12 float32 and integer
// instructions (scale and bias, max, exp, the sums, P's split), so
// instruction issue, the tensor pipe and latency bound it, not bytes:
// 0.72 ms at that shape against 1.98 for the float32 kernel on the same
// values, 0.37 against 0.97 at (400, 400, 4) (scripts/kernel_variants.py
// tri_bf16, H100 80GB HBM3, 700 W).
//
// Design (FlashAttention-2 on mma.sync.m16n8k16 bf16):
//  - q.k is one bf16 product with a float32 accumulator. A bf16 x bf16
//    product has at most 16 significant bits, so every term is exact in
//    float32 and the sum rounds as a float32 dot product does. The scale
//    1/sqrt(D) and the bias come after it, in float32 (q scaled first would
//    no longer be bf16); exp(x - m) is 2^(x log2(e) - m log2(e)), one FMA
//    before ex2.approx.ftz;
//  - P.V with V exact and P split into three bf16 terms: hi the top 8
//    significant bits of p (its high 16 bits), mid those of p - hi, lo the
//    rest, at most 8 bits. hi + mid + lo = p exactly, so nothing is dropped
//    and every product is exact; the split is integer masks, two exact
//    subtractions and byte permutes. Two terms rounded to nearest drop up
//    to 2^-16 of p: 0.63 ms, but 3.6e-6 from float64 against 1.1e-6. As in
//    the float32 kernel, each tile's products get fresh accumulators (hi
//    apart from mid and lo) and are added to the running output with
//    round-to-nearest FMAs, since the tensor cores truncate;
//  - S's accumulator layout is P's A-operand layout with m16n8k16, so P
//    never leaves registers; K and V come to the fragments by ldmatrix (V
//    transposed) from a 3-stage cp.async ring of 32-key tiles (80-byte
//    rows: conflict-free), one barrier a tile;
//  - the bias is read from device memory once for several rows. A block
//    serves one query tile of 64 and one head over G rows, as two row
//    streams of 4 warps with their own rings and barriers (rows r0, r0 + 2,
//    ... and r0 + 1, r0 + 3, ...). On its first row each thread fetches
//    the bias words its accumulator fragment needs; in stream 0 it keeps
//    them in its own words of shared memory (64 x L values, 2 bytes each
//    for a bf16 bias: 47 KB at L=368), which its later rows read back. Its
//    twin in stream 1 needs the same words: it fetches them itself on its
//    first row, and reads stream 0's from its second row on, once stream 0
//    has passed the end of its first row (barrier 3: stream 0 arrives,
//    stream 1 waits), so no word is written by two threads or read while
//    it is written (stream 1's wait there costs about 1 %: 0.727 -> 0.734
//    ms at (512, 368, 8), 0.366 -> 0.371 at (400, 400, 4), against both
//    streams storing). The first row runs its own instance of the tile
//    code, so the others carry no fetch branch. Bias
//    reads fall from R L^2 H (the float32 kernel's, 1.1 GB in bf16 at that
//    shape) to 2 R L^2 H / G. The launcher takes G = 16 where that leaves 4
//    waves of blocks (two blocks an SM, 16 warps) and G = 8 otherwise, so
//    each stream reads the bias once for 4 or 8 rows: the bias read for
//    every row costs 0.84 ms there, G = 8 0.75, G = 16 0.72; G = 16 at
//    (400, 400, 4), 700 blocks where 4 waves are 1056, 0.40 against 0.37;
//  - measured and not kept (same source, one edit each): wgmma m64n32k16
//    with q and P as register A operands and K, V tiles as core matrices,
//    0.78 ms (each product's commit and wait serialises the warpgroup); the
//    row sums on the tensor cores, 0.76; one stream of 4 warps a block at
//    three blocks an SM, 0.74; 64-key tiles at one block an SM, 0.84.
// Keys past L are zero-filled and score -inf; queries past L load zeros
// and store nothing; bias words past L are clamped reads, masked.
// --------------------------------------------------------------------------

constexpr int BF_BQ = 64;                 // queries per block, 16 a warp
constexpr int BF_BK = 32;                 // keys per shared-memory tile
constexpr int BF_HALF = 128;              // a row stream: 4 warps
constexpr int BF_HALVES = 2;              // row streams per block
constexpr int BF_THREADS = BF_HALVES * BF_HALF;
constexpr int BF_STAGES = 3;              // K, V ring: one barrier a tile
constexpr int BF_ROWS_MIN = 8;            // G: rows per block, one bias
constexpr int BF_ROWS_MAX = 16;           // read; the launcher picks G
constexpr int BF_WAVES = 4;               // ... keeping this many waves
constexpr int BF_SROW = D + 8;            // shared row, bf16: 80 bytes
constexpr int BF_TILE = BF_BK * BF_SROW;  // bf16 of one (BK, D) tile
constexpr int BF_CHUNKS = BF_BK * D / 8 / BF_HALF;   // 16-byte copies
constexpr int BF_RING_BYTES = BF_HALVES * BF_STAGES * 2 * BF_TILE * 2;
constexpr int BF_SMEM_MAX = 232448;       // a block's dynamic shared memory

// c += a.b, m16n8k16, bf16 operands, float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory (shared-space byte address
// s), the row addresses of matrix i from lanes 8i .. 8i + 7; with trans,
// each transposed
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t s) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// x with its low 16 bits cleared: bf16 by truncation, as a float
__device__ __forceinline__ float bf16_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// the bf16 pair {a (low half), b (high half)} of two floats whose low 16
// bits are dropped
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// One thread's bias values at keys (j, j + 1) of one query, as the staged
// word: a bf16 pair, or two floats
template <typename T> struct BiasWord;
template <> struct BiasWord<uint16_t> {
  using Word = uint32_t;
  static __device__ __forceinline__ Word fetch(const uint16_t* p,
                                               long long o0, long long o1) {
    return (uint32_t)__ldg(p + o0) | ((uint32_t)__ldg(p + o1) << 16);
  }
  static __device__ __forceinline__ Word pair(const uint16_t* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  static __device__ __forceinline__ float first(Word w) {
    return __uint_as_float(w << 16);
  }
  static __device__ __forceinline__ float second(Word w) {
    return __uint_as_float(w & 0xffff0000u);
  }
};
template <> struct BiasWord<float> {
  using Word = float2;
  static __device__ __forceinline__ Word fetch(const float* p, long long o0,
                                               long long o1) {
    return make_float2(__ldg(p + o0), __ldg(p + o1));
  }
  static __device__ __forceinline__ Word pair(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ float first(Word w) { return w.x; }
  static __device__ __forceinline__ float second(Word w) { return w.y; }
};

// 2^x, results below 2^-126 flushed to 0 (a softmax weight that small
// adds nothing to a float32 sum whose largest term is 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename BiasT>
__global__ void __launch_bounds__(BF_THREADS, 2)
tri_attn_fwd_kernel_bf16(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const BiasT* __restrict__ bias,
                         float* __restrict__ out, int R, int L,
                         long long q_sr, long long q_sp, long long k_sr,
                         long long k_sp, long long v_sr, long long v_sp,
                         long long o_sr, long long o_sp, long long b_si,
                         long long b_sj, long long b_sh, float s_scale,
                         float l2e, int rows_per_block, int stage_bias,
                         int pair_loads) {
  using BW = BiasWord<BiasT>;
  using Word = typename BW::Word;
  constexpr int TILE_WORDS = BF_BK / 8 * 2 * BF_HALF;   // staged a tile
  extern __shared__ __align__(16) unsigned char bf_smem[];
  // the block's rows r0 + half, r0 + half + 2, ... are this half's, with
  // its own ring of K, V tiles and its own barrier; both halves serve the
  // same queries, so a thread and its twin in the other half need the
  // same bias words: half 0 stages them, half 1 reads them after barrier 3
  const int half = threadIdx.x / BF_HALF;
  const int tid = threadIdx.x % BF_HALF;
  uint16_t* ring = reinterpret_cast<uint16_t*>(bf_smem) +
                   half * BF_STAGES * 2 * BF_TILE;        // [stage][K|V]
  // this thread's staged bias words: tile kt, 8-key step nt, row qa (0)
  // or qb (1) at [(kt * BF_BK / 8 + nt) * 2 + row] * BF_HALF
  Word* const staged =
      reinterpret_cast<Word*>(bf_smem + BF_RING_BYTES) + tid;

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;        // accumulator row group
  const int t = lane & 3;         // thread in the group
  const int h = blockIdx.y;
  const long long r0 = (long long)blockIdx.z * rows_per_block + half;
  const long long in_block = min((long long)rows_per_block, R - r0 + half);
  const int n_rows = (int)((in_block - half + BF_HALVES - 1) / BF_HALVES);
  if (n_rows <= 0) return;
  // half 1 has a second row, where it reads half 0's staged words
  const bool handoff =
      BF_HALVES > 1 && stage_bias && in_block >= 2 * BF_HALVES;
  const int qa = blockIdx.x * BF_BQ + warp * 16 + g;   // this thread's rows
  const int qb = qa + 8;          // rows g and g + 8 of the warp
  const int n_kt = (L + BF_BK - 1) / BF_BK;
  auto half_sync = [half]() {     // this half's 4 warps
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + half), "n"(BF_HALF)
                 : "memory");
  };

  // the loader: (row, key tile) in turn into a ring of BF_STAGES stages
  // (shared-space byte addresses), one commit group a step (empty past the
  // last); this thread's 16-byte chunks are (key jj, d col .. col + 7) of
  // a tile, each with its own source pointers
  constexpr uint32_t STAGE_BYTES = 2 * BF_TILE * 2;
  const uint32_t ring_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  int c_jj[BF_CHUNKS];
  uint32_t c_dst[BF_CHUNKS];
  const uint16_t* c_k[BF_CHUNKS];
  const uint16_t* c_v[BF_CHUNKS];
#pragma unroll
  for (int c = 0; c < BF_CHUNKS; ++c) {
    const int e = tid + c * BF_HALF;
    const int col = (e % (D / 8)) * 8;
    c_jj[c] = e / (D / 8);
    c_dst[c] = ring_s + 2 * (c_jj[c] * BF_SROW + col);
    c_k[c] = k + r0 * k_sr + h * D + c_jj[c] * k_sp + col;
    c_v[c] = v + r0 * v_sr + h * D + c_jj[c] * v_sp + col;
  }
  const long long k_tile = BF_BK * k_sp, v_tile = BF_BK * v_sp;
  const long long k_next = BF_HALVES * k_sr - (long long)n_kt * k_tile;
  const long long v_next = BF_HALVES * v_sr - (long long)n_kt * v_tile;
  int l_keys = L, l_left = n_rows * n_kt;   // keys from the tile's first
  uint32_t l_stage = 0;           // byte offset of the stage
  auto load_next = [&]() {
    if (l_left-- > 0) {
#pragma unroll
      for (int c = 0; c < BF_CHUNKS; ++c) {
        const bool ok = c_jj[c] < l_keys;
        cp_async16_s(c_dst[c] + l_stage, ok ? c_k[c] : k, ok);
        cp_async16_s(c_dst[c] + l_stage + BF_TILE * 2, ok ? c_v[c] : v, ok);
        c_k[c] += k_tile;
        c_v[c] += v_tile;
      }
      l_keys -= BF_BK;
      if (l_keys <= 0) {
        l_keys = L;
#pragma unroll
        for (int c = 0; c < BF_CHUNKS; ++c) {
          c_k[c] += k_next;
          c_v[c] += v_next;
        }
      }
      l_stage = l_stage == (BF_STAGES - 1) * STAGE_BYTES
                    ? 0 : l_stage + STAGE_BYTES;
    }
    cp_async_commit();
  };

  load_next();
  load_next();

  // this lane's ldmatrix row: K, matrix i = d 8i .. 8i + 7 of an 8-key
  // step's key lane % 8; V (transposed), matrices (keys 0-7, d 0-7),
  // (keys 8-15, d 0-7), (keys 0-7, d 8-15), (keys 8-15, d 8-15) of a
  // 16-key step
  const int k_lane = (lane & 7) * BF_SROW + (lane >> 3) * 8;
  const int v_lane = ((lane & 7) + (lane & 8)) * BF_SROW + (lane >> 4) * 8;

  const BiasT* ba = bias + (long long)min(qa, L - 1) * b_si + h * b_sh;
  const BiasT* bb = bias + (long long)min(qb, L - 1) * b_si + h * b_sh;
  const uint16_t* qra = q + r0 * q_sr + (long long)min(qa, L - 1) * q_sp +
                        h * D;
  const uint16_t* qrb = q + r0 * q_sr + (long long)min(qb, L - 1) * q_sp +
                        h * D;
  float* ora = out + r0 * o_sr + (long long)qa * o_sp + h * D + 2 * t;
  float* orb = out + r0 * o_sr + (long long)qb * o_sp + h * D + 2 * t;

  uint32_t qf[D / 16][4];         // q's A fragments, exact bf16 pairs
  float o[D / 8][4];              // (qa, 8 dn + 2t + {0,1}), (qb, ...)
  float ma = -INFINITY, mb = -INFINITY;   // running max of the logits
  float la = 0.f, lb = 0.f;               // this thread's share of the sums
  uint32_t stage = 0;             // byte offset of the stage
  int j0 = 0;
  // this thread's ldmatrix rows in stage 0
  const uint32_t k_rows = ring_s + 2 * k_lane;
  const uint32_t v_rows = ring_s + 2 * (BF_TILE + v_lane);
  Word* mine = staged;

  // one key tile of the current row; FETCH: its bias words come from
  // device memory (the block's first row, or every row where they are
  // not staged), else from this thread's staged words
  auto tile = [&](auto fetch_tag) {
    constexpr bool FETCH = decltype(fetch_tag)::value;
    const bool ragged = j0 + BF_BK > L;     // the row's last tile
    Word bw[BF_BK / 8][2];
    if constexpr (!FETCH) {
#pragma unroll
      for (int nt = 0; nt < BF_BK / 8; ++nt) {
        bw[nt][0] = mine[(2 * nt) * BF_HALF];
        bw[nt][1] = mine[(2 * nt + 1) * BF_HALF];
      }
    } else if (!ragged && pair_loads) {     // keys j, j + 1 side by side
#pragma unroll
      for (int nt = 0; nt < BF_BK / 8; ++nt) {
        bw[nt][0] = BW::pair(ba + j0 + nt * 8 + 2 * t);
        bw[nt][1] = BW::pair(bb + j0 + nt * 8 + 2 * t);
      }
    } else if (!ragged) {
      const long long off = (j0 + 2 * t) * b_sj;
#pragma unroll
      for (int nt = 0; nt < BF_BK / 8; ++nt) {
        const long long o0 = off + nt * 8 * b_sj;
        bw[nt][0] = BW::fetch(ba, o0, o0 + b_sj);
        bw[nt][1] = BW::fetch(bb, o0, o0 + b_sj);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < BF_BK / 8; ++nt) {
        const int j = j0 + nt * 8 + 2 * t;
        const long long o0 = (long long)min(j, L - 1) * b_sj;
        const long long o1 = (long long)min(j + 1, L - 1) * b_sj;
        bw[nt][0] = BW::fetch(ba, o0, o1);
        bw[nt][1] = BW::fetch(bb, o0, o1);
      }
    }

    cp_async_wait1();              // this step's tiles landed
    half_sync();                   // ... for the half's threads; a stage
                                   // is free
    load_next();
    const uint32_t ks = k_rows + stage, vs = v_rows + stage;

    // logits: s[nt] holds keys j0 + 8 nt + 2t + {0, 1} of rows qa (0, 1)
    // and qb (2, 3). q.k is one bf16 product of exact terms; the scale and
    // the bias come after it, in float32; keys past L score -inf
    float s[BF_BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BF_BK / 8; ++nt) {
      uint32_t kb[4];
      ldsm_x4(kb, ks + 2 * nt * 8 * BF_SROW);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(acc, qf[0], kb[0], kb[1]);
      mma_bf16(acc, qf[1], kb[2], kb[3]);
      s[nt][0] = fmaf(acc[0], s_scale, BW::first(bw[nt][0]));
      s[nt][1] = fmaf(acc[1], s_scale, BW::second(bw[nt][0]));
      s[nt][2] = fmaf(acc[2], s_scale, BW::first(bw[nt][1]));
      s[nt][3] = fmaf(acc[3], s_scale, BW::second(bw[nt][1]));
    }
    if (FETCH && stage_bias && half == 0) {
#pragma unroll
      for (int nt = 0; nt < BF_BK / 8; ++nt) {
        mine[(2 * nt) * BF_HALF] = bw[nt][0];
        mine[(2 * nt + 1) * BF_HALF] = bw[nt][1];
      }
    }
    if (ragged) {
#pragma unroll
      for (int nt = 0; nt < BF_BK / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j0 + nt * 8 + 2 * t + (i & 1) >= L) s[nt][i] = -INFINITY;
    }

    // online softmax over this tile, rows qa and qb
    float mxa = ma, mxb = mb;
#pragma unroll
    for (int nt = 0; nt < BF_BK / 8; ++nt) {
      mxa = fmaxf(mxa, fmaxf(s[nt][0], s[nt][1]));
      mxb = fmaxf(mxb, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {     // the 4 threads of a row group
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, w));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, w));
    }
    // exp(x - m) as 2^(x log2(e) - m log2(e)): one FMA before ex2
    const float ca = ex2((ma - mxa) * l2e);   // 0 on a row's first tile
    const float cb = ex2((mb - mxb) * l2e);
    ma = mxa;
    mb = mxb;
    const float na = -ma * l2e, nb = -mb * l2e;
    la *= ca;
    lb *= cb;
#pragma unroll
    for (int nt = 0; nt < BF_BK / 8; ++nt) {
      s[nt][0] = ex2(fmaf(s[nt][0], l2e, na));   // 0 for masked keys
      s[nt][1] = ex2(fmaf(s[nt][1], l2e, na));
      s[nt][2] = ex2(fmaf(s[nt][2], l2e, nb));
      s[nt][3] = ex2(fmaf(s[nt][3], l2e, nb));
      la += s[nt][0] + s[nt][1];
      lb += s[nt][2] + s[nt][3];
    }

    // this tile's P.V: P = hi + mid + lo exactly, three bf16 terms (each
    // the top 8 significant bits of what is left), V exact; a 16-key step
    // kk takes P's A operand from s[2kk] and s[2kk + 1] as they are
    float pv_hi[D / 8][4], pv_lo[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int i = 0; i < 4; ++i) pv_hi[dn][i] = pv_lo[dn][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BF_BK / 16; ++kk) {
      uint32_t vb[2][4];
      ldsm_x4_trans(vb[0], vs + 2 * kk * 16 * BF_SROW);
      ldsm_x4_trans(vb[1], vs + 2 * (kk * 16 * BF_SROW + 16));
      const float p[8] = {s[2 * kk][0], s[2 * kk][1], s[2 * kk][2],
                          s[2 * kk][3], s[2 * kk + 1][0], s[2 * kk + 1][1],
                          s[2 * kk + 1][2], s[2 * kk + 1][3]};
      float rest[8], last[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        rest[e] = p[e] - bf16_trunc(p[e]);          // exact
        last[e] = rest[e] - bf16_trunc(rest[e]);    // exact, <= 8 bits
      }
      uint32_t phi[4], pmid[4], plo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        phi[i] = bf16_pair(p[2 * i], p[2 * i + 1]);
        pmid[i] = bf16_pair(rest[2 * i], rest[2 * i + 1]);
        plo[i] = bf16_pair(last[2 * i], last[2 * i + 1]);
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const uint32_t b0 = vb[dn >> 1][(dn & 1) * 2];
        const uint32_t b1 = vb[dn >> 1][(dn & 1) * 2 + 1];
        mma_bf16(pv_lo[dn], plo, b0, b1);
        mma_bf16(pv_lo[dn], pmid, b0, b1);
        mma_bf16(pv_hi[dn], phi, b0, b1);
      }
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] = fmaf(o[dn][0], ca, pv_hi[dn][0] + pv_lo[dn][0]);
      o[dn][1] = fmaf(o[dn][1], ca, pv_hi[dn][1] + pv_lo[dn][1]);
      o[dn][2] = fmaf(o[dn][2], cb, pv_hi[dn][2] + pv_lo[dn][2]);
      o[dn][3] = fmaf(o[dn][3], cb, pv_hi[dn][3] + pv_lo[dn][3]);
    }

    stage = stage == (BF_STAGES - 1) * STAGE_BYTES ? 0 : stage + STAGE_BYTES;
    mine += TILE_WORDS;
  };

  for (int row = 0; row < n_rows; ++row) {
    // a0 (qa, d), a1 (qb, d), a2 (qa, d + 8), a3 (qb, d + 8),
    // d = 16 ks + 2t and d + 1 in one word
    const uint32_t* pa = reinterpret_cast<const uint32_t*>(qra);
    const uint32_t* pb = reinterpret_cast<const uint32_t*>(qrb);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      qf[ks][0] = qa < L ? pa[8 * ks + t] : 0u;
      qf[ks][1] = qb < L ? pb[8 * ks + t] : 0u;
      qf[ks][2] = qa < L ? pa[8 * ks + 4 + t] : 0u;
      qf[ks][3] = qb < L ? pb[8 * ks + 4 + t] : 0u;
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[dn][i] = 0.f;
    ma = mb = -INFINITY;
    la = lb = 0.f;
    mine = staged;
    if (row == 0 || !stage_bias) {
      for (j0 = 0; j0 < L; j0 += BF_BK) tile(std::true_type());
      if (handoff && half == 0)   // half 0's staged words are written
        asm volatile("bar.arrive 3, %0;\n" :: "n"(BF_THREADS) : "memory");
    } else {
      if (handoff && half == 1 && row == 1)   // ... and visible here
        asm volatile("bar.sync 3, %0;\n" :: "n"(BF_THREADS) : "memory");
      for (j0 = 0; j0 < L; j0 += BF_BK) tile(std::false_type());
    }

    // normalise, store
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      la += __shfl_xor_sync(0xffffffffu, la, w);
      lb += __shfl_xor_sync(0xffffffffu, lb, w);
    }
    const float ia = 1.f / la, ib = 1.f / lb;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      if (qa < L)
        *reinterpret_cast<float2*>(ora + dn * 8) =
            make_float2(o[dn][0] * ia, o[dn][1] * ia);
      if (qb < L)
        *reinterpret_cast<float2*>(orb + dn * 8) =
            make_float2(o[dn][2] * ib, o[dn][3] * ib);
    }
    qra += BF_HALVES * q_sr;
    qrb += BF_HALVES * q_sr;
    ora += BF_HALVES * o_sr;
    orb += BF_HALVES * o_sr;
  }
}

template <typename BiasT>
int launch_bf16(const void* q, const void* k, const void* v,
                const BiasT* bias, float* out, int rows, int L, int H,
                long long q_sr, long long q_sp, long long k_sr,
                long long k_sp, long long v_sr, long long v_sp,
                long long o_sr, long long o_sp, long long b_si,
                long long b_sj, long long b_sh, cudaStream_t stream) {
  using Word = typename BiasWord<BiasT>::Word;
  const int n_kt = (L + BF_BK - 1) / BF_BK;
  const long long staged =
      (long long)n_kt * (BF_BK / 8) * 2 * BF_HALF * sizeof(Word);
  const int stage = BF_RING_BYTES + staged <= BF_SMEM_MAX;
  const int smem = BF_RING_BYTES + (stage ? (int)staged : 0);
  const cudaError_t attr = cudaFuncSetAttribute(
      tri_attn_fwd_kernel_bf16<BiasT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  // G: the most rows a block that still leave BF_WAVES waves of blocks
  // (two blocks an SM), BF_ROWS_MIN at least
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long tiles = (long long)((L + BF_BQ - 1) / BF_BQ) * H;
  int G = BF_ROWS_MAX;
  while (G > BF_ROWS_MIN &&
         tiles * ((rows + G - 1) / G) < (long long)BF_WAVES * 2 * sms)
    G /= 2;
  // bias words of keys (j, j + 1) in one load: the pair side by side and
  // aligned to its size
  const int pair_loads =
      b_sj == 1 && b_si % 2 == 0 && b_sh % 2 == 0 &&
      reinterpret_cast<uintptr_t>(bias) % (2 * sizeof(BiasT)) == 0;
  const dim3 grid((L + BF_BQ - 1) / BF_BQ, H, (rows + G - 1) / G);
  tri_attn_fwd_kernel_bf16<BiasT><<<grid, BF_THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), bias, out, rows, L, q_sr, q_sp, k_sr,
      k_sp, v_sr, v_sp, o_sr, o_sp, b_si, b_sj, b_sh,
      (float)(1.0 / sqrt((double)D)), (float)1.4426950408889634, G, stage,
      pair_loads);
  return (int)cudaGetLastError();
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

// The same for bf16 q, k and v (same strides, in elements, 16-byte aligned
// per (row, position, head) vector) with a bf16 (bias_bf16 != 0) or
// float32 bias; out is float32, as above. Returns cudaGetLastError()
// after the launch.
extern "C" int trx2dy_tri_attn_fwd_bf16(
    const void* q, const void* k, const void* v, const void* bias,
    int bias_bf16, float* out, int rows, int L, int H, int head_dim,
    long long q_sr, long long q_sp, long long k_sr, long long k_sp,
    long long v_sr, long long v_sp, long long o_sr, long long o_sp,
    long long b_si, long long b_sj, long long b_sh, void* stream) {
  if (rows <= 0 || L <= 0 || H <= 0 || rows > 65535 || H > 65535 ||
      L > 65535 || head_dim != D)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias_bf16)
    return launch_bf16(q, k, v, static_cast<const uint16_t*>(bias), out,
                       rows, L, H, q_sr, q_sp, k_sr, k_sp, v_sr, v_sp, o_sr,
                       o_sp, b_si, b_sj, b_sh, s);
  return launch_bf16(q, k, v, static_cast<const float*>(bias), out, rows, L,
                     H, q_sr, q_sp, k_sr, k_sp, v_sr, v_sp, o_sr, o_sp, b_si,
                     b_sj, b_sh, s);
}

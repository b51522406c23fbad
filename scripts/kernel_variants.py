#!/usr/bin/env python3
"""Time the shipped CUDA kernels against variants that undo one design
choice each, on one NVIDIA GPU.

Every variant is a textual edit of a source in trx2dy_torch/csrc, built
with the same nvcc flags into build/variants/ and called through the
port's own wrapper. Each prints one JSON line: its max error against a
float64 plain version and its time at the main path's shapes (triangle
attention at L=400 with the trunk's head-major bias, mean of the row- and
column-wise call; the fused spline pair entry at the L=150, B=50 fold's
pair lists, kernel time by torch.profiler and wrapper time by CUDA
events; the spline dense entry's four terms at chip_smoke.py's
(B, L) = (50, 150) and (3, 37), kernel time warm and L2-flushed and
wrapper time, beside the entry's earlier design (one launch and one
PyTorch sum of its partials per term, its wrapper's per-call checks);
the spline lanes entry at chip_smoke.py's three lane maps and
both lengths, L=150 and 64, C=32, kernel time by torch.profiler warm and
after a 256 MB write that flushes the L2 before every launch, as a fold
finds it after the ~600 small launches between two evaluations).
Variants are timed in turns, shipped first and last.

    python3 scripts/kernel_variants.py [tri] [tri_bf16] [pairs] [lanes] [dense]

(no argument: all five). tri_bf16: the bf16-operand kernel's variants on
bf16 inputs at AlphaFold2's MSA-row launch (R, L, H) = (512, 368, 8) and
at a triangle launch (400, 400, 4), beside the float32 kernel on the same
values.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import trx2dy_torch.ops.spline_energy as se  # noqa: E402
import trx2dy_torch.ops.triangle_attention as ta  # noqa: E402
from trx2dy_torch.ops import _build  # noqa: E402

OUT = ROOT / "build" / "variants"

PV_SHIPPED = """#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const int at = row + dn * 8;
        const uint32_t h0 = vhi[at], h1 = vhi[at + SROW];
        mma(small[dn], plo, h0, h1);
        mma(small[dn], phi, vlo[at], vlo[at + SROW]);
        mma(big[dn], phi, h0, h1);
      }"""
PV_SIDE_BY_SIDE = """#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        mma(small[dn], plo, vhi[row + dn * 8], vhi[row + dn * 8 + SROW]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        mma(small[dn], phi, vlo[row + dn * 8], vlo[row + dn * 8 + SROW]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        mma(big[dn], phi, vhi[row + dn * 8], vhi[row + dn * 8 + SROW]);"""
TRI = {
    "shipped": [],
    "one float32 accumulator chain across all key tiles": [
        ("    float big[D / 8][4], small[D / 8][4];\n"
         "#pragma unroll\n"
         "    for (int dn = 0; dn < D / 8; ++dn)\n"
         "#pragma unroll\n"
         "      for (int i = 0; i < 4; ++i) big[dn][i] = small[dn][i] = 0.f;",
         "#pragma unroll\n"
         "    for (int dn = 0; dn < D / 8; ++dn)\n"
         "#pragma unroll\n"
         "      for (int i = 0; i < 4; ++i) o[dn][i] *= i < 2 ? ca : cb;\n"
         "    float (&big)[D / 8][4] = o;\n"
         "    float (&small)[D / 8][4] = o;"),
        ("      o[dn][0] = fmaf(o[dn][0], ca, big[dn][0] + small[dn][0]);\n"
         "      o[dn][1] = fmaf(o[dn][1], ca, big[dn][1] + small[dn][1]);\n"
         "      o[dn][2] = fmaf(o[dn][2], cb, big[dn][2] + small[dn][2]);\n"
         "      o[dn][3] = fmaf(o[dn][3], cb, big[dn][3] + small[dn][3]);\n",
         "")],
    "64-key tiles, 3 blocks per SM": [
        ("constexpr int BK = 32;", "constexpr int BK = 64;"),
        ("__launch_bounds__(THREADS, 4)", "__launch_bounds__(THREADS, 3)")],
    "no minimum of blocks per SM": [
        ("__launch_bounds__(THREADS, 4)", "__launch_bounds__(THREADS)")],
    "volatile mma (no reordering of products)": [
        ("  asm(\n      \"mma.sync", "  asm volatile(\n      \"mma.sync")],
    "P.V products of 4 accumulators side by side": [
        (PV_SHIPPED, PV_SIDE_BY_SIDE)],
    "warps whose queries are all past L skip": [
        ("  const int qb = qa + 8;\n",
         "  const int qb = qa + 8;\n"
         "  const bool live = blockIdx.x * BQ + warp * 16 < L;\n"),
        ("    load_tile(kt + 2);\n",
         "    load_tile(kt + 2);\n    if (!live) continue;\n")],
    "8-key steps past L skip": [
        ("        mma(small, qlo[ks], h0, h1);\n"
         "        mma(small, qhi[ks], klo[at], klo[at + 4]);\n"
         "        mma(big, qhi[ks], h0, h1);",
         "        if (j0 + nt * 8 < L) {\n"
         "          mma(small, qlo[ks], h0, h1);\n"
         "          mma(small, qhi[ks], klo[at], klo[at + 4]);\n"
         "          mma(big, qhi[ks], h0, h1);\n"
         "        }"),
        ("      uint32_t phi[4], plo[4];",
         "      if (j0 + ks * 8 >= L) continue;   // p is 0 past L\n"
         "      uint32_t phi[4], plo[4];")],
}
# The bf16-operand kernel (tri_attn_fwd_kernel_bf16)
PSPLIT_SHIPPED = """      float rest[8], last[8];
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
      }"""
PSPLIT_TWO_NEAREST = """      uint32_t phi[4], pmid[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        asm("cvt.rn.bf16x2.f32 %0, %1, %2;\\n"
            : "=r"(phi[i]) : "f"(p[2 * i + 1]), "f"(p[2 * i]));
        const float r0 = p[2 * i] - __uint_as_float(phi[i] << 16);
        const float r1 = p[2 * i + 1] - __uint_as_float(phi[i] & 0xffff0000u);
        asm("cvt.rn.bf16x2.f32 %0, %1, %2;\\n"
            : "=r"(pmid[i]) : "f"(r1), "f"(r0));
      }"""
# wgmma for both products: K and V tiles in shared memory as 8 x 16-byte
# core matrices (an 8-key group's four 16-byte chunks of d one after the
# other), q and P as register A operands, V read transposed (MN-major)
WG_HELPERS = r"""// wgmma: shared-memory matrix descriptor (no swizzle), the accumulator
// fences and an m64n32k16 product with A from registers
__device__ __forceinline__ uint64_t wg_desc(uint32_t s, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((s & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ void wg_keep(float (&d)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}
__device__ __forceinline__ void wg_fence(float (&d)[4][4]) {
  wg_keep(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[4][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc),
        "n"(TRANS_B));
}

// 2^x, results below 2^-126 flushed to 0"""


# descriptors: K (K-major) leading byte offset 128 (the next 8 d), stride 512
# (the next 8 keys); V (MN-major, transposed) leading 512 (the next 8 keys),
# stride 128 (the next 8 d)
WGMMA_EDITS = [
        ("// 2^x, results below 2^-126 flushed to 0", WG_HELPERS),
        ("    c_dst[c] = ring_s + 2 * (c_jj[c] * BF_SROW + col);",
         "    c_dst[c] = ring_s + (c_jj[c] >> 3) * 512 + (col >> 3) * 128 +\n"
         "               (c_jj[c] & 7) * 16;"),
        ("    cp_async_wait1();              // this step's tiles landed\n",
         "    cp_async_wait1();              // this step's tiles landed\n"
         "    asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: "
         "\"memory\");\n"),
        ("""#pragma unroll
    for (int nt = 0; nt < BF_BK / 8; ++nt) {
      uint32_t kb[4];
      ldsm_x4(kb, ks + 2 * nt * 8 * BF_SROW);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(acc, qf[0], kb[0], kb[1]);
      mma_bf16(acc, qf[1], kb[2], kb[3]);
""", """    float sacc[BF_BK / 8][4];
    wg_fence(sacc);
    wgmma_rs<0>(sacc, qf[0], wg_desc(ring_s + stage, 128, 512), 0);
    wgmma_rs<0>(sacc, qf[1], wg_desc(ring_s + stage + 256, 128, 512), 1);
    wg_commit();
    wg_wait0();
    wg_keep(sacc);
#pragma unroll
    for (int nt = 0; nt < BF_BK / 8; ++nt) {
      const float (&acc)[4] = sacc[nt];
"""),
        ("""      uint32_t vb[2][4];
      ldsm_x4_trans(vb[0], vs + 2 * kk * 16 * BF_SROW);
      ldsm_x4_trans(vb[1], vs + 2 * (kk * 16 * BF_SROW + 16));
""", ""),
        ("""#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const uint32_t b0 = vb[dn >> 1][(dn & 1) * 2];
        const uint32_t b1 = vb[dn >> 1][(dn & 1) * 2 + 1];
        mma_bf16(pv_lo[dn], plo, b0, b1);
        mma_bf16(pv_lo[dn], pmid, b0, b1);
        mma_bf16(pv_hi[dn], phi, b0, b1);
      }
    }
""", """      const uint64_t vd = wg_desc(ring_s + stage + 2 * BF_TILE + kk * 1024,
                                  512, 128);
      wg_fence(pv_lo);
      wg_keep(pv_hi);
      wgmma_rs<1>(pv_lo, plo, vd, kk > 0);
      wgmma_rs<1>(pv_lo, pmid, vd, 1);
      wgmma_rs<1>(pv_hi, phi, vd, kk > 0);
      wg_commit();
    }
    wg_wait0();
    wg_keep(pv_lo);
    wg_keep(pv_hi);
""")]


TRI_BF16 = {
    "shipped": [],
    "P in two bf16 terms (hi and the rest rounded to nearest)": [
        (PSPLIT_SHIPPED, PSPLIT_TWO_NEAREST),
        ("        mma_bf16(pv_lo[dn], plo, b0, b1);\n", "")],
    "one accumulator for the three terms": [
        ("mma_bf16(pv_lo[dn], plo", "mma_bf16(pv_hi[dn], plo"),
        ("mma_bf16(pv_lo[dn], pmid", "mma_bf16(pv_hi[dn], pmid")],
    "64-key tiles (1 block per SM)": [
        ("constexpr int BF_BK = 32;", "constexpr int BF_BK = 64;"),
        ("__launch_bounds__(BF_THREADS, 2)",
         "__launch_bounds__(BF_THREADS, 1)")],
    "one row stream (4 warps) per block, 3 blocks per SM": [
        ("constexpr int BF_HALVES = 2;", "constexpr int BF_HALVES = 1;"),
        ("__launch_bounds__(BF_THREADS, 2)",
         "__launch_bounds__(BF_THREADS, 3)")],
    "at most 8 rows per block (G <= 8)": [
        ("constexpr int BF_ROWS_MAX = 16;", "constexpr int BF_ROWS_MAX = 8;")],
    "16 rows per block at every shape (G = 16)": [
        ("constexpr int BF_ROWS_MIN = 8;", "constexpr int BF_ROWS_MIN = 16;")],
    "the bias pair's keys fetched one by one": [
        ("  const int pair_loads =\n", "  const int pair_loads = 0 &&\n")],
    "wgmma m64n32k16 for q.k and the three P.V terms": WGMMA_EDITS,
    "row sums on the tensor cores (P times a column of ones)": [
        ("      s[nt][3] = ex2(fmaf(s[nt][3], l2e, nb));\n"
         "      la += s[nt][0] + s[nt][1];\n"
         "      lb += s[nt][2] + s[nt][3];\n",
         "      s[nt][3] = ex2(fmaf(s[nt][3], l2e, nb));\n"),
        ("    const float na = -ma * l2e, nb = -mb * l2e;\n"
         "    la *= ca;\n    lb *= cb;\n",
         "    const float na = -ma * l2e, nb = -mb * l2e;\n"),
        ("    float pv_hi[D / 8][4], pv_lo[D / 8][4];\n",
         "    float pv_hi[D / 8][4], pv_lo[D / 8][4];\n"
         "    float lsum[4] = {0.f, 0.f, 0.f, 0.f};\n"),
        ("        mma_bf16(pv_hi[dn], phi, b0, b1);\n      }\n    }\n",
         "        mma_bf16(pv_hi[dn], phi, b0, b1);\n      }\n"
         "      mma_bf16(lsum, plo, 0x3f803f80u, 0x3f803f80u);\n"
         "      mma_bf16(lsum, pmid, 0x3f803f80u, 0x3f803f80u);\n"
         "      mma_bf16(lsum, phi, 0x3f803f80u, 0x3f803f80u);\n    }\n"
         "    la = fmaf(la, ca, lsum[0]);\n    lb = fmaf(lb, cb, lsum[2]);\n"),
        ("#pragma unroll\n    for (int w = 1; w < 4; w <<= 1) {\n"
         "      la += __shfl_xor_sync(0xffffffffu, la, w);\n"
         "      lb += __shfl_xor_sync(0xffffffffu, lb, w);\n    }\n", "")],
    "the bias read from device memory for every row": [
        ("  const int stage = BF_RING_BYTES + staged <= BF_SMEM_MAX;",
         "  const int stage = 0;")],
}
SPLINE = {
    "shipped": [],
    "one tile per block (no tile loop)": [
        ("  return (int)((tiles + slots - 1) / slots);", "  return 1;")],
    "2 pairs per thread per tile": [
        ("constexpr int PAIR_ELEMS = 4;", "constexpr int PAIR_ELEMS = 2;")],
    "8 pairs per thread per tile, 3 blocks per SM": [
        ("constexpr int PAIR_ELEMS = 4;", "constexpr int PAIR_ELEMS = 8;"),
        ("constexpr int PAIR_BLOCKS_PER_SM = 4;",
         "constexpr int PAIR_BLOCKS_PER_SM = 3;")],
    "2 blocks per SM": [("constexpr int PAIR_BLOCKS_PER_SM = 4;",
                         "constexpr int PAIR_BLOCKS_PER_SM = 2;")],
    "2 pairs per thread per tile, 6 blocks per SM": [
        ("constexpr int PAIR_ELEMS = 4;", "constexpr int PAIR_ELEMS = 2;"),
        ("constexpr int PAIR_BLOCKS_PER_SM = 4;",
         "constexpr int PAIR_BLOCKS_PER_SM = 6;")],
    "fence by the partials' writers only": [
        ("unsigned int total, bool* flag) {\n  __threadfence();",
         "unsigned int total, bool* flag,\n"
         "                                            "
         "int writers = 1 << 30) {\n"
         "  if ((int)threadIdx.x < writers) __threadfence();"),
        ("arrive_last(groups + grp, gend - gb0, &flag)",
         "arrive_last(groups + grp, gend - gb0, &flag, W)"),
        ("arrive_last(finals + blockIdx.y, n_groups, &flag)",
         "arrive_last(finals + blockIdx.y, n_groups, &flag, W)")],
    "streaming loads of q": [
        ("qv[e] = in[e] ? q[p * B + b] : 0.f;",
         "qv[e] = in[e] ? __ldcs(q + p * B + b) : 0.f;")],
}

# The dense entry. Its earlier design, appended to the source beside
# the shipped one and called as its wrapper called it
# (one_term_dense_fwd): per
# term one launch, one thread per pair with its table row read from device
# memory per decoy, a block per 8 decoys, a binary search with a branch per
# extrapolation case and three divisions per query, and the (B, n_blocks)
# partials summed by a second launch.
DENSE_ONE_TERM = r"""
namespace {
constexpr int ONE_TERM_THREADS = 256;
constexpr int ONE_TERM_DECOYS = 8;

__device__ __forceinline__ void one_term_spline_at(
    const float* __restrict__ xs, int K, const float* __restrict__ y,
    const float* __restrict__ m, float q, float& val, float& der) {
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
    const float s =
        (yl - y[K - 2]) / hn + hn * (m[K - 2] + 2.f * m[K - 1]) / 6.f;
    val = yl + s * (q - xl);
    der = s;
    return;
  }
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

__global__ void __launch_bounds__(ONE_TERM_THREADS)
spline_one_term_kernel(const float* __restrict__ y,
                        const float* __restrict__ m,
                        const float* __restrict__ x, int K,
                        const float* __restrict__ q,
                        const uint8_t* __restrict__ mask, long long n_pairs,
                        int B, float* __restrict__ partial,
                        float* __restrict__ deriv) {
  __shared__ float xs[MAX_K];
  __shared__ float red[ONE_TERM_DECOYS][ONE_TERM_THREADS / 32];
  for (int i = threadIdx.x; i < K; i += ONE_TERM_THREADS) xs[i] = x[i];
  __syncthreads();
  const long long p = (long long)blockIdx.x * ONE_TERM_THREADS + threadIdx.x;
  const bool on = p < n_pairs && mask[p] != 0;
  const float* yr = y + p * K;
  const float* mr = m + p * K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * ONE_TERM_DECOYS;
  for (int bl = 0; bl < ONE_TERM_DECOYS; ++bl) {
    const int b = b0 + bl;
    float v = 0.f;
    if (b < B && p < n_pairs) {
      float d = 0.f;
      if (on)
        one_term_spline_at(xs, K, yr, mr, q[(long long)b * n_pairs + p], v,
                           d);
      deriv[(long long)b * n_pairs + p] = d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[bl][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < ONE_TERM_DECOYS) {
    const int b = b0 + threadIdx.x;
    if (b < B) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < ONE_TERM_THREADS / 32; ++w) s += red[threadIdx.x][w];
      partial[(long long)b * gridDim.x + blockIdx.x] = s;
    }
  }
}
}  // namespace

extern "C" int trx2dy_spline_one_term_blocks(long long n_pairs) {
  return (int)((n_pairs + ONE_TERM_THREADS - 1) / ONE_TERM_THREADS);
}

extern "C" int trx2dy_spline_one_term(const float* y, const float* m,
                                       const float* x, int K, const float* q,
                                       const uint8_t* mask, long long n_pairs,
                                       int B, float* partial, int n_blocks,
                                       float* deriv, void* stream) {
  if (K < 2 || K > MAX_K || B <= 0 || n_pairs <= 0 ||
      n_blocks != trx2dy_spline_one_term_blocks(n_pairs) ||
      (B + ONE_TERM_DECOYS - 1) / ONE_TERM_DECOYS > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_blocks, (B + ONE_TERM_DECOYS - 1) / ONE_TERM_DECOYS);
  spline_one_term_kernel<<<grid, ONE_TERM_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      y, m, x, K, q, mask, n_pairs, B, partial, deriv);
  return (int)cudaGetLastError();
}
"""
DENSE_END = ("  return dense_launch(terms, n_terms, q, B, buf, counter, "
             "device, stream);\n}\n")
DENSE = {
    "shipped": [],
    "tables re-read from L2 every step (one step of decoys a y-block)": [
        ("  long long split = slots / blocks;",
         "  long long split = steps;")],
    "every table row copied, masked pairs too": [
        ("          if (on_s[p1] || on_s[p2] || p2 > p1 + 1) pa[c] = p1;",
         "          pa[c] = p1;")],
    "table float4s loaded one at a time": [
        ("constexpr int DENSE_COPY = 4;", "constexpr int DENSE_COPY = 1;")],
    "no prefetch of the next step's queries": [
        ("        qv[e] = qn[e];                            // step's loads "
         "start here\n"
         "        const int b = bb + DENSE_BATCH + ln + DENSE_LANES * e;\n"
         "        qn[e] = on && b < c1 ? q[b * P + p] : 0.f;",
         "        const int b = bb + ln + DENSE_LANES * e;\n"
         "        qv[e] = on && b < c1 ? q[b * P + p] : 0.f;")],
    "the distance past the end knots by branches": [
        ("        const float off = qq - fminf(fmaxf(qq, x0), xl);",
         "        const float off = qq < x0 ? qq - x0 : qq > xl ? qq - xl "
         ": 0.f;")],
    "the 6-step knot search for every K": [
        ("count_le<TOP>(xs, qq)", "count_le(xs, qq)")],
    "256 threads (2 decoy lanes), 4 blocks per SM": [
        ("constexpr int DENSE_THREADS = 128;",
         "constexpr int DENSE_THREADS = 256;"),
        ("constexpr int DENSE_BLOCKS_PER_SM = 6;",
         "constexpr int DENSE_BLOCKS_PER_SM = 4;")],
    "earlier design: one launch and one partial sum per term": [
        (DENSE_END, DENSE_END + DENSE_ONE_TERM)],
}


# The lanes entry. Each variant undoes one choice of its design; `data`
# says which table storage its launch is given: "tab" the shipped interval
# tables of the used rows (P, U', K-1, 4) behind the lane -> row map,
# "tab_expanded" one such table per lane under the identity map, "ym" the
# used rows' y, m (P, U', K) behind the map, "ym_expanded" per-lane y, m
# (P, C, K), the earlier storage.
LANES_TAB_PTR = """    const float4* __restrict__ tab =
        LANES ? reinterpret_cast<const float4*>(y) +
                    pick(a.row, ti)[b] * (K - 1)
              : nullptr;
    const int pstride = LANES ? pick(a.U, ti) * (K - 1) : 0;"""
LANES_ROW = """    const int rb = LANES ? pick(a.row, ti)[b] : 0;
    const int Uv = LANES ? pick(a.U, ti) : 0;"""
LANES_LOAD = """          const float4 v = __ldg(tab + pr * pstride + k[e]);
          ya[e] = v.x;
          yb[e] = v.y;
          ma[e] = v.z;
          mb[e] = v.w;"""


def scalar_loads(index: str):
    return """          const int rw = %s;
          ya[e] = y[rw];
          yb[e] = y[rw + 1];
          ma[e] = m[rw];
          mb[e] = m[rw + 1];""" % index


CP_ASYNC = r"""// cp.async of 4 bytes into shared memory; zero-filled and
// reading nothing where !ok
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 4 : 0));
}

template <bool LANES>
__global__ void __launch_bounds__(PAIR_THREADS, PAIR_BLOCKS_PER_SM)"""
TILE_LOADS = """    for (int p0 = first; p0 < last; p0 += tile) {
      float qv[PAIR_ELEMS];
      bool in[PAIR_ELEMS], on[PAIR_ELEMS];
#pragma unroll
      for (int e = 0; e < PAIR_ELEMS; ++e) {      // every load started first
        const int p = p0 + e * R;
        in[e] = p < last;
        on[e] = in[e] && act[in[e] ? (LANES ? p * B + b : p) : 0] != 0;
        qv[e] = in[e] ? q[p * B + b] : 0.f;
      }"""
# each thread copies its own elements' q and the 4-byte word holding its
# activity byte (so the activity tensor's size must be a multiple of 4,
# true at C=32) into its own slots of a two-stage buffer, one tile ahead;
# no other thread reads them, so no barrier is needed
TILE_LOADS_PREFETCH = r"""    const unsigned* __restrict__ actw =
        reinterpret_cast<const unsigned*>(act);
    auto fetch = [&](int pb, int st) {
#pragma unroll
      for (int e = 0; e < PAIR_ELEMS; ++e) {
        const int p = pb + e * R;
        const bool ok = p < last;
        cp_async4(&qbuf[st][e][tid], q + (ok ? p * B + b : 0), ok);
        cp_async4(&abuf[st][e][tid],
                  actw + ((ok ? (LANES ? p * B + b : p) : 0) >> 2), ok);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
    fetch(first, 0);
    int st = 0;
    for (int p0 = first; p0 < last; p0 += tile, st ^= 1) {
      fetch(p0 + tile, st ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
      float qv[PAIR_ELEMS];
      bool in[PAIR_ELEMS], on[PAIR_ELEMS];
#pragma unroll
      for (int e = 0; e < PAIR_ELEMS; ++e) {
        const int p = p0 + e * R;
        const int ia = LANES ? p * B + b : p;
        in[e] = p < last;
        on[e] = in[e] && ((abuf[st][e][tid] >> (8 * (ia & 3))) & 0xffu) != 0;
        qv[e] = in[e] ? qbuf[st][e][tid] : 0.f;
      }"""
LANES_VARIANTS = {
    "shipped": ("tab", []),
    "expanded per-lane tables, one float4 load": ("tab_expanded", []),
    "row-mapped y, m, four scalar loads": ("ym", [
        (LANES_TAB_PTR, LANES_ROW),
        (LANES_LOAD, scalar_loads("(pr * Uv + rb) * K + k[e]"))]),
    "cp.async prefetch of the next tile's q and act": ("tab", [
        ("template <bool LANES>\n__global__ void __launch_bounds__"
         "(PAIR_THREADS, PAIR_BLOCKS_PER_SM)", CP_ASYNC),
        ("  __shared__ bool flag;\n",
         "  __shared__ bool flag;\n"
         "  __shared__ float qbuf[2][PAIR_ELEMS][PAIR_THREADS];\n"
         "  __shared__ unsigned abuf[2][PAIR_ELEMS][PAIR_THREADS];\n"),
        (TILE_LOADS, TILE_LOADS_PREFETCH),
        ("  const float blk = rows_sum(",
         "  asm volatile(\"cp.async.wait_all;\\n\" ::);\n"
         "  const float blk = rows_sum(")]),
    "earlier design: per-lane y, m, four scalar loads": ("ym_expanded", [
        (LANES_TAB_PTR, LANES_ROW),
        (LANES_LOAD, scalar_loads("(pr * B + b) * K + k[e]"))]),
}


def build_variants(source: str, variants: dict, tag: str = "") -> dict:
    """{variant: ctypes.CDLL}, every variant compiled at once, into files
    named by source, tag and the variant's index."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{source} variant {name!r}: anchor "
                                   f"{old[:40]!r} is not in the source "
                                   "exactly once")
            text = text.replace(old, new)
        cu = OUT / f"{source}_{tag}{n}.cu"
        cu.write_text(text)
        so = OUT / f"lib{source}_{tag}{n}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} {name!r}:\n{log}")
        regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill stores" in ln]
        print(f"built {source} {name!r}: {'; '.join(regs)}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def tri_fn(lib):
    """The library's (float32, bf16) entries, as ta._lib returns them."""
    f32, bf16 = lib.trx2dy_tri_attn_fwd, lib.trx2dy_tri_attn_fwd_bf16
    f32.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                    + [ctypes.c_longlong] * 11 + [ctypes.c_void_p])
    bf16.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                     + [ctypes.c_void_p] + [ctypes.c_int] * 4
                     + [ctypes.c_longlong] * 11 + [ctypes.c_void_p])
    f32.restype = bf16.restype = ctypes.c_int
    return f32, bf16


def spline_lib(lib):
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for entry in ("dense", "pairs", "lanes"):
        size = getattr(lib, f"trx2dy_spline_{entry}_buffer")
        size.argtypes, size.restype = [vp, i, i, i, vp], ll
        launch = getattr(lib, f"trx2dy_spline_{entry}")
        launch.argtypes = [vp, i, vp, i, vp, vp, i, vp]
        launch.restype = ctypes.c_int
    return lib


def fold_pair_lists(dev, B: int = 50, L: int = 150):
    """The four terms' bucketed pair lists of a full L=150 mask and edge
    queries, as chip_smoke.py's spline phase makes them."""
    from trx2dy_torch.physics.compact import _compact_term
    from trx2dy_torch.physics.restraints import compile_restraints
    rst = compile_restraints(cs.random_histograms(L, seed=L))
    idx = np.arange(L)
    full = {"dist": idx[:, None] < idx, "omega": idx[:, None] < idx,
            "theta": idx[:, None] != idx, "phi": idx[:, None] != idx}
    terms, qs = [], []
    for grid in cs.GRIDS:
        ct = _compact_term(getattr(rst, grid), full[grid])
        P, K = ct.y.shape
        terms.append(tuple(torch.as_tensor(np.asarray(a), device=dev)
                           for a in (ct.y, ct.m, ct.x, ct.act)))
        qs.append(torch.as_tensor(cs.edge_queries(ct.x, (P, B), seed=K + P,
                                                  pair_major=True),
                                  device=dev))
    return terms, qs


def lanes_inputs(dev, L: int, maps: dict):
    """Per lane map: the lanes entry's terms (tab, row, x, act) and
    queries as chip_smoke.py's lanes check makes them (16 random
    histograms of length L, a full union, C=32 lanes)."""
    from trx2dy_torch.physics.compact import _bucket
    from trx2dy_torch.physics.tablegen import union_compiler
    C = cs.CHAIN_LANES
    hists = [cs.random_histograms(L, seed=L + u) for u in range(16)]
    pool = {g: torch.as_tensor(np.stack([h[g] for h in hists]), device=dev)
            for g in cs.GRIDS}
    comp = union_compiler("A" * L, device=dev)
    P = tuple(_bucket(int(c)) for c in comp.count(pool)[0].tolist())
    for name, lane_map in maps.items():
        ur, _, _, r2 = comp.compile(pool, lane_map, P)
        rng = np.random.default_rng(5)
        terms, qs = [], []
        for t, a in zip(ur, r2):
            on = torch.as_tensor(rng.random(tuple(a.shape)) < 0.8,
                                 device=dev)
            terms.append((t.tab, t.row, t.x, (a & on).contiguous()))
            x = t.x.cpu().numpy()
            qs.append(torch.as_tensor(cs.edge_queries(
                x, (t.tab.shape[0], C), seed=len(x) + 7, pair_major=True),
                device=dev))
        yield name, terms, qs


def lanes_tables(lib, terms, data: str):
    """The lanes entry's SplineLanes over `terms` with the table storage a
    variant reads (LANES_VARIANTS), built for `lib`."""
    se._lib = lambda: lib
    C = terms[0][1].shape[0]
    ident = torch.arange(C, dtype=torch.int32, device=terms[0][0].device)
    if data == "tab":
        return se.SplineLanes(terms), None
    if data == "tab_expanded":
        return se.SplineLanes([(tab.index_select(1, row.long()).contiguous(),
                                ident, x, act)
                               for tab, row, x, act in terms]), None
    # y, m storage: the checks run on the shipped terms, the launch
    # constants point at y and m (the variants' kernels read y and m)
    tables = se.SplineLanes(terms)
    keep = []
    for tab, row, x, act in terms:
        rows = row if data == "ym_expanded" else torch.arange(
            tab.shape[1], device=tab.device)
        y, m = se.expand_lane_tables(tab, rows)
        keep.append((y.contiguous(), m.contiguous(), x, act, row))
    tables._c = (se._PairTerm * len(terms))(*(
        se._PairTerm(y.data_ptr(), m.data_ptr(), x.data_ptr(),
                     act.data_ptr(), row.data_ptr(), y.shape[0], x.shape[0],
                     y.shape[1])
        for y, m, x, act, row in keep))
    tables._qptrs = (ctypes.c_void_p * len(terms))()
    return tables, keep


def lanes_variants(dev) -> None:
    libs = {k: spline_lib(v) for k, v in build_variants(
        "spline_energy", {n: e for n, (_, e) in LANES_VARIANTS.items()
                          if n == "shipped" or e}, "lanes").items()}
    order = list(LANES_VARIANTS) + ["shipped"]   # shipped first and last
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    for L in (cs.SPLINE_SHAPES[0][1], cs.CLI_L):
        for name, terms, qs in lanes_inputs(dev, L, cs.lane_maps()):
            ref_sums, ref_derivs = se.spline_lanes_plain(
                [(tab.double(), row, x.double(), act)
                 for tab, row, x, act in terms], [q.double() for q in qs])
            shipped = None
            for variant in order:
                data, edits = LANES_VARIANTS[variant]
                lib = libs[variant if edits else "shipped"]
                tables, keep = lanes_tables(lib, terms, data)
                sums, derivs = se._lanes_fwd(tables, qs)
                torch.cuda.synchronize()
                if shipped is None:
                    shipped = (sums, derivs)
                same = torch.equal(sums, shipped[0]) and all(
                    torch.equal(a, b) for a, b in zip(derivs, shipped[1]))
                diff = max([(sums - shipped[0]).abs().max().item()] + [
                    (a - b).abs().max().item()
                    for a, b in zip(derivs, shipped[1])])
                sum_err = max(((s_.double() - r).abs().max()
                               / r.abs().max()).item()
                              for s_, r in zip(sums, ref_sums))
                deriv_err = max(((d.double() - r).abs()
                                 / r.abs().clamp_min(1.0)).max().item()
                                for d, r in zip(derivs, ref_derivs))
                launch = lambda: se._lanes_fwd(tables, qs)
                warm = cs.kernel_device_ms(launch, "spline_pairs_kernel",
                                           iters=50)
                cold = cs.kernel_device_ms(
                    lambda: (flush.zero_(), launch()), "spline_pairs_kernel",
                    iters=50)
                print("variant " + json.dumps({
                    "kernel": "spline_energy_lanes", "L": L, "C": 32,
                    "map": name, "variant": variant, "data": data,
                    "sum_rel_err": sum_err, "deriv_err": deriv_err,
                    "bit_identical_to_shipped": same,
                    "max_abs_diff_to_shipped": diff,
                    "kernel_ms": warm, "kernel_ms_l2_flushed": cold,
                    "wrapper_ms": cs.time_ms(launch, iters=50)}),
                    flush=True)
                del tables, keep
            del terms, qs, ref_sums, ref_derivs
    se._lib = _lib_shipped


_lib_shipped = se._lib
_tri_lib_shipped = ta._lib


def main(argv=None) -> int:
    which = set(sys.argv[1:] if argv is None else argv) or \
        {"tri", "tri_bf16", "pairs", "lanes", "dense"}
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if "lanes" in which:
        lanes_variants(dev)
    order = lambda d: list(d) + ["shipped"]    # shipped first and last
    if "tri" in which:
        tri_variants(dev, order)
    if "tri_bf16" in which:
        tri_bf16_variants(dev, order)
    if "pairs" in which:
        pair_variants(dev, order)
    if "dense" in which:
        dense_variants(dev, order)
    return 0


def tri_variants(dev, order) -> None:
    tri = {k: tri_fn(v) for k, v in build_variants(
        "triangle_attention", TRI).items()}
    q, k, v, bias = cs.tri_attn_inputs(400, dev, seed=400)
    refs = {w: ta.tri_attn_core_plain(q.double(), k.double(), v.double(),
                                      bias.double(), w).float()
            for w in ("row", "col")}
    for name in order(tri):
        ta._lib = lambda fns=tri[name]: fns
        err = max((ta.tri_attn_core(q, k, v, bias, w) - refs[w]).abs()
                  .max().item() for w in refs)
        ms = sum(cs.time_ms(lambda w=w: ta.tri_attn_core(q, k, v, bias, w),
                            iters=20) for w in refs) / 2
        print("variant " + json.dumps({"kernel": "tri_attn_fwd", "L": 400,
                                       "variant": name, "max_abs_err": err,
                                       "ms": ms}), flush=True)
    del refs
    ta._lib = _tri_lib_shipped


def tri_bf16_variants(dev, order) -> None:
    """The bf16 kernel's variants on bf16 inputs at AlphaFold2's MSA-row
    launch, (R, L, H) = (512, 368, 8), row-wise, and at a triangle launch,
    (400, 400, 4), the mean of row- and column-wise; beside the float32
    kernel on the same values (its shipped build)."""
    tri = {k: tri_fn(v) for k, v in build_variants(
        "triangle_attention", TRI_BF16, tag="bf16_").items()}
    cases = {}
    for shape in ((512, 368, 8), (400, 400, 4)):
        R, L, H = shape
        q, k, v, bias = cs.tri_attn_inputs(L, dev, seed=R + L, rows=R,
                                           heads=H, dtype=torch.bfloat16)
        wises = ("row",) if R != L else ("row", "col")
        refs = {w: ta.tri_attn_core_plain(q.double(), k.double(), v.double(),
                                          bias.double(), w).float()
                for w in wises}
        cases[shape] = ((q, k, v, bias), refs)

    def run(name, inputs, refs, shape):
        err = max((ta.tri_attn_core(*inputs, w) - refs[w]).abs().max()
                  .item() for w in refs)
        ms = sum(cs.time_ms(lambda w=w: ta.tri_attn_core(*inputs, w),
                            iters=20) for w in refs) / len(refs)
        print("variant " + json.dumps({
            "kernel": "tri_attn_fwd.bf16", "shape": list(shape),
            "variant": name, "dtype": str(inputs[0].dtype),
            "max_abs_err": err, "ms": ms}), flush=True)

    for name in order(tri):
        ta._lib = lambda fns=tri[name]: fns
        for shape, (inputs, refs) in cases.items():
            run(name, inputs, refs, shape)
    ta._lib = _tri_lib_shipped
    for shape, (inputs, refs) in cases.items():
        run("the float32 kernel on the same values",
            tuple(t.float() for t in inputs), refs, shape)


def pair_variants(dev, order) -> None:
    spl = {k: spline_lib(v) for k, v in build_variants(
        "spline_energy", SPLINE).items()}
    terms, qs = fold_pair_lists(dev)
    ref_sums, ref_derivs = se.spline_pairs_plain(
        [(y.double(), m.double(), x.double(), a) for y, m, x, a in terms],
        [q.double() for q in qs])
    for name in order(spl):
        se._lib = lambda lib=spl[name]: lib
        tables = se.SplinePairs(terms)     # fresh layout for this build
        sums, derivs = se._pairs_fwd(tables, qs)
        sum_err = max(((s.double() - r).abs().max() / r.abs().max()).item()
                      for s, r in zip(sums, ref_sums))
        deriv_err = max(((d.double() - r).abs() / r.abs().clamp_min(1.0))
                        .max().item() for d, r in zip(derivs, ref_derivs))
        wrapper = cs.time_ms(lambda: se._pairs_fwd(tables, qs), iters=50)
        kernel = cs.kernel_device_ms(lambda: se._pairs_fwd(tables, qs),
                                     "spline_pairs_kernel", iters=50)
        print("variant " + json.dumps({
            "kernel": "spline_energy_pairs", "B": 50, "variant": name,
            "sum_rel_err": sum_err, "deriv_err": deriv_err,
            "kernel_ms": kernel, "wrapper_ms": wrapper}), flush=True)
    se._lib = _lib_shipped



def dense_inputs(dev, B: int, L: int):
    """The dense entry's four terms (y, m, x, mask) and (B, L, L) queries
    as chip_smoke.py's spline phase makes them."""
    from trx2dy_torch.physics.restraints import compile_restraints, \
        restraint_masks
    rst = compile_restraints(cs.random_histograms(L, seed=L))
    masks = restraint_masks(rst, "A" * L, 1, L)
    terms, qs = [], []
    for grid in cs.GRIDS:
        tab = getattr(rst, grid)
        K = tab.x.shape[0]
        terms.append(tuple(torch.as_tensor(np.asarray(a), device=dev)
                           for a in (tab.y, tab.m, tab.x,
                                     getattr(masks, grid))))
        qs.append(torch.as_tensor(cs.edge_queries(tab.x, (B, L, L),
                                                  seed=K + L), device=dev))
    return terms, qs


def one_term_dense_fwd(lib, terms, qs):
    """The earlier dense wrapper, once per term: the per-call checks, a
    (B, n_blocks) partial and a deriv allocated, a launch under the
    tensor's device context, and the partials summed by PyTorch."""
    out = []
    for (y, m, x, mask), q in zip(terms, qs):
        B, L, _ = q.shape
        K = x.shape[0]
        for t, shape, dt in ((y, (L, L, K), torch.float32),
                             (m, (L, L, K), torch.float32),
                             (x, (K,), torch.float32),
                             (mask, (L, L), torch.bool)):
            if t.device != q.device or t.dtype != dt or \
                    tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError("one-term dense: malformed input")
        if q.dtype != torch.float32 or not q.is_contiguous():
            raise ValueError("one-term dense: malformed q")
        n_blocks = lib.trx2dy_spline_one_term_blocks(L * L)
        partial = torch.empty((B, n_blocks), dtype=torch.float32,
                              device=q.device)
        deriv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.trx2dy_spline_one_term(
                y.data_ptr(), m.data_ptr(), x.data_ptr(), K, q.data_ptr(),
                mask.data_ptr(), L * L, B, partial.data_ptr(), n_blocks,
                deriv.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(
                f"one-term dense launch failed: cudaError {err}")
        out.append((partial.sum(dim=1), deriv))
    return torch.stack([o[0] for o in out]), tuple(o[1] for o in out)


def dense_variants(dev, order) -> None:
    libs = {k: spline_lib(v) for k, v in build_variants(
        "spline_energy", DENSE, "dense").items()}
    earlier = "earlier design: one launch and one partial sum per term"
    lib = libs[earlier]
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.trx2dy_spline_one_term_blocks.argtypes = [ll]
    lib.trx2dy_spline_one_term_blocks.restype = i
    lib.trx2dy_spline_one_term.argtypes = [vp, vp, vp, i, vp, vp, ll, i,
                                            vp, i, vp, vp]
    lib.trx2dy_spline_one_term.restype = i
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    for B, L in cs.SPLINE_SHAPES:
        terms, qs = dense_inputs(dev, B, L)
        ref_sums, ref_derivs = se.spline_dense_terms_plain(
            [(y.double(), m.double(), x.double(), mk)
             for y, m, x, mk in terms], [q.double() for q in qs])
        for name in order(libs):
            if name == earlier:
                launch = lambda: one_term_dense_fwd(lib, terms, qs)
                kernel = "spline_one_term_kernel"
            else:
                se._lib = lambda lib=libs[name]: lib
                tables = se.SplineDense(terms)   # fresh layout, this build
                launch = lambda tables=tables: se._dense_fwd(tables, qs)
                kernel = "spline_dense_kernel"
            sums, derivs = launch()
            torch.cuda.synchronize()
            sum_err = max(((s_.double() - r).abs().max()
                           / r.abs().max().clamp_min(1.0)).item()
                          for s_, r in zip(sums, ref_sums))
            deriv_err = max(((d.double() - r).abs()
                             / r.abs().clamp_min(1.0)).max().item()
                            for d, r in zip(derivs, ref_derivs))
            print("variant " + json.dumps({
                "kernel": "spline_energy_dense", "B": B, "L": L,
                "variant": name, "sum_rel_err": sum_err,
                "deriv_err": deriv_err,
                "kernel_ms": cs.kernel_device_ms(launch, kernel, iters=50),
                "kernel_ms_l2_flushed": cs.kernel_device_ms(
                    lambda: (flush.zero_(), launch()), kernel, iters=50),
                "wrapper_ms": cs.time_ms(launch, iters=50)}), flush=True)
        del terms, qs, ref_sums, ref_derivs
    se._lib = _lib_shipped


if __name__ == "__main__":
    sys.exit(main())

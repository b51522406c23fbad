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
events). Variants are timed in turns, shipped first and last.

    python3 scripts/kernel_variants.py
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
         "                                            int writers) {\n"
         "  if ((int)threadIdx.x < writers) __threadfence();"),
        ("arrive_last(groups + grp, gend - gb0, &flag)",
         "arrive_last(groups + grp, gend - gb0, &flag, W)"),
        ("arrive_last(finals + blockIdx.y, n_groups, &flag)",
         "arrive_last(finals + blockIdx.y, n_groups, &flag, W)")],
    "streaming loads of q": [
        ("qv[e] = in[e] ? q[p * B + b] : 0.f;",
         "qv[e] = in[e] ? __ldcs(q + p * B + b) : 0.f;")],
}


def build_variants(source: str, variants: dict) -> dict:
    """{variant: ctypes.CDLL}, every variant compiled at once."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, (name, edits) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{source} variant {name!r}: anchor "
                                   f"{old[:40]!r} not in the source")
            text = text.replace(old, new)
        cu = OUT / f"{source}_{n}.cu"
        cu.write_text(text)
        so = OUT / f"lib{source}_{n}.so"
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
    fn = lib.trx2dy_tri_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 11 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def spline_lib(lib):
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.trx2dy_spline_pairs_buffer.argtypes = [vp, i, i, i, vp]
    lib.trx2dy_spline_pairs_buffer.restype = ll
    lib.trx2dy_spline_pairs.argtypes = [vp, i, vp, i, vp, vp, i, vp]
    lib.trx2dy_spline_pairs.restype = ctypes.c_int
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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    tri = {k: tri_fn(v) for k, v in build_variants(
        "triangle_attention", TRI).items()}
    spl = {k: spline_lib(v) for k, v in build_variants(
        "spline_energy", SPLINE).items()}
    order = lambda d: list(d) + ["shipped"]    # shipped first and last

    q, k, v, bias = cs.tri_attn_inputs(400, dev, seed=400)
    refs = {w: ta.tri_attn_core_plain(q.double(), k.double(), v.double(),
                                      bias.double(), w).float()
            for w in ("row", "col")}
    for name in order(tri):
        ta._lib = lambda fn=tri[name]: fn
        err = max((ta.tri_attn_core(q, k, v, bias, w) - refs[w]).abs()
                  .max().item() for w in refs)
        ms = sum(cs.time_ms(lambda w=w: ta.tri_attn_core(q, k, v, bias, w),
                            iters=20) for w in refs) / 2
        print("variant " + json.dumps({"kernel": "tri_attn_fwd", "L": 400,
                                       "variant": name, "max_abs_err": err,
                                       "ms": ms}), flush=True)
    del refs

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
    return 0


if __name__ == "__main__":
    sys.exit(main())

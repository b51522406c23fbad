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
events; the spline lanes entry at chip_smoke.py's three lane maps and
both lengths, L=150 and 64, C=32, kernel time by torch.profiler warm and
after a 256 MB write that flushes the L2 before every launch, as a fold
finds it after the ~600 small launches between two evaluations).
Variants are timed in turns, shipped first and last.

    python3 scripts/kernel_variants.py [tri] [pairs] [lanes]

(no argument: all three).
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
            if old not in text:
                raise RuntimeError(f"{source} variant {name!r}: anchor "
                                   f"{old[:40]!r} not in the source")
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
    fn = lib.trx2dy_tri_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 11 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def spline_lib(lib):
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for entry in ("pairs", "lanes"):
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


def main(argv=None) -> int:
    which = set(sys.argv[1:] if argv is None else argv) or \
        {"tri", "pairs", "lanes"}
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
    if "pairs" in which:
        pair_variants(dev, order)
    return 0


def tri_variants(dev, order) -> None:
    tri = {k: tri_fn(v) for k, v in build_variants(
        "triangle_attention", TRI).items()}
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


if __name__ == "__main__":
    sys.exit(main())

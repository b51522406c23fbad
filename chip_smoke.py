#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (trx2dy_torch) on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA device, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases; any failure exits non-zero and no phase is skipped:
  1. the card's name and power limit, from nvidia-smi;
  2. build every kernel from trx2dy_torch/csrc (one nvcc each, together)
     into build/kernels/;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, within the stated tolerance of a
     float64 computation; kernel, plain and library times beside the bound
     the card's data sheet gives. Triangle attention row- and column-wise;
     the spline restraint energy's dense entry at (B, L) = (50, 150) and
     (3, 37) and its pair entry at the bucketed pair count of a full L=150
     mask with B=50, for all four knot grids, with queries below, on and
     above the knots;
  4. the main path, first half: the geometry stage (a3m -> features ->
     Predictor2D at full width, depth 12, random seeded weights ->
     pred_npz for both models) answers three requests at L = 64, 256, 400
     with 1000 MSA rows. Outputs are checked for shape, finiteness and
     normalisation, and the L=256 request is recomputed on the plain path
     on the card;
  5. the main path, second half: the folder folds (a) a seeded synthetic
     compact target at L=150 into 50 decoys (mode 2, max_iter 1000, no
     relax, orientation restraints on) through fold_ensemble, and (b) the
     L=64 NMR pred_npz of phase 4 into 8 decoys through the fold CLI, whose
     PDBs are read back. Energies must be finite and below each decoy's
     start; the spline pair kernel must launch 4 times per energy
     evaluation; (a)'s final decoys are rescored through the dense entry
     (batched_energy_fused) and must match. Request (b) is held to the
     plain spline path on the card: first energy and gradient within 1e-4,
     final energy medians within FOLD_MEDIAN_TOL; a repeated evaluation
     must be bit-identical (the fold is deterministic). One 250-iteration
     L-BFGS chunk of (a) is profiled;
  6. a `kernels` JSON line, then {"ok": true, "device": {...}} last.

Launch counts are set to 0 just before each request of phases 4 and 5 and
read just after it; a kernel of a path that did not launch fails the run.

It exits non-zero, printing no result, where CUDA is unavailable or the
port is not beside it.
"""
from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "smoke"

KERNEL_LENGTHS = (37, 256, 400)
REQUEST_LENGTHS = (64, 256, 400)
MSA_ROWS = 1000
DEPTH = 12
KERNEL_TOL = 5e-3          # against float64, as tests/test_pallas_ops.py
PLAIN_PATH_TOL = 1e-3      # probabilities, kernel path vs plain path
HEADS, HEAD_DIM = 4, 32

SPLINE_SHAPES = ((50, 150), (3, 37))   # dense entry (B, L)
SPLINE_SUM_TOL = 1e-5      # per-decoy sums, relative to sum |value|
SPLINE_DERIV_TOL = 1e-4    # dE/dq, times max(1, |reference|)
SPLINE_FLOPS = 40          # per active query: search, cubic, derivative
GRIDS = ("dist", "omega", "theta", "phi")
FOLD_L, FOLD_DECOYS, FOLD_ITERS = 150, 50, 1000   # headline request (a)
CLI_L, CLI_DECOYS = 64, 8                          # request (b)
FOLD_START_TOL = 1e-4      # first energy and gradient, kernel vs plain path
# final energy medians, kernel vs plain path. The fold is deterministic,
# but the two paths' trajectories diverge from rounding, and which decoys
# land in which minimum moves a median of 8: the two medians differed by
# 3.8 % (means 1.6 %) in a deterministic run of this script (PERF.md)
FOLD_MEDIAN_TOL = 0.10
RESCORE_TOL = 1e-4         # dense-entry rescoring vs the fold's energies
PROFILE_ITERS = 250        # one STAGE_CHUNK

# Data-sheet peaks: float32 outside the tensor cores, and memory rate.
DATASHEETS = {
    "H100 PCIe": (51e12, 2.0e12),
    "H100 NVL": (60e12, 3.9e12),
    "H200": (67e12, 4.8e12),
    "H100 SXM": (67e12, 3.35e12),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def datasheet(name: str):
    """The data sheet matching a device name; the SXM part's otherwise
    (its name, e.g. "NVIDIA H100 80GB HBM3", does not say SXM)."""
    for key, peaks in DATASHEETS.items():
        if all(word in name for word in key.split()):
            return key, peaks
    return "H100 SXM", DATASHEETS["H100 SXM"]


def time_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def event_device_us(e) -> float:
    """Self device time of a torch.profiler key_averages() entry, in us."""
    return getattr(e, "self_device_time_total", None) or \
        getattr(e, "self_cuda_time_total", 0.0)


def kernel_device_ms(fn, kernel: str, iters: int = 20):
    """Mean device time in ms of the kernels whose name contains `kernel`
    per fn() call, from torch.profiler; None where the profiler shows no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(event_device_us(e) for e in prof.key_averages()
             if kernel in e.key)
    return us / iters / 1e3 if us else None


# --------------------------------------------------------------------------
# kernels against their plain versions
# --------------------------------------------------------------------------

def tri_attn_inputs(L: int, dev, seed: int):
    """q, k, v as the trunk makes them (views into one (L, L, 384) qkv
    projection), and the (L, L, H) bias."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(L, L, 3 * HEADS * HEAD_DIM, generator=gen).to(dev)
    q, k, v = (t.reshape(L, L, HEADS, HEAD_DIM)
               for t in torch.chunk(qkv, 3, dim=-1))
    bias = torch.randn(L, L, HEADS, generator=gen).to(dev)
    return q, k, v, bias


def sdpa_tri_attn(q, k, v, bias, wise):
    """The library yardstick: scaled_dot_product_attention with the bias as
    a float mask. Timed only; the port never calls it."""
    if wise == "col":
        q, k, v = (t.transpose(0, 1) for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        *(t.permute(0, 2, 1, 3) for t in (q, k, v)),
        attn_mask=bias.permute(2, 0, 1))
    out = out.permute(0, 2, 1, 3)
    return out.transpose(0, 1) if wise == "col" else out


def tri_attn_bound_ms(L: int, peaks) -> tuple[float, str]:
    flops = 4.0 * L ** 3 * HEADS * HEAD_DIM          # q.k and p.v products
    nbytes = 4.0 * (4 * L * L * HEADS * HEAD_DIM     # q, k, v in; out
                    + L * L * HEADS)                 # bias
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes \
        else "bytes"


def kernel_phase(dev, peaks, lengths=KERNEL_LENGTHS):
    from trx2dy_torch.ops.triangle_attention import (
        tri_attn_core, tri_attn_core_plain)
    rows = []
    for L in lengths:
        q, k, v, bias = tri_attn_inputs(L, dev, seed=L)
        for wise in ("row", "col"):
            before = tri_attn_core.launches
            out = tri_attn_core(q, k, v, bias, wise)
            torch.cuda.synchronize()
            check(tri_attn_core.launches == before + 1,
                  f"tri_attn L={L} {wise}: launch counter did not advance")
            ref = tri_attn_core_plain(q.double(), k.double(), v.double(),
                                      bias.double(), wise)
            check(bool(torch.isfinite(out).all()),
                  f"tri_attn L={L} {wise}: non-finite output")
            err = (out.double() - ref).abs().max().item()
            check(err <= KERNEL_TOL,
                  f"tri_attn L={L} {wise}: max abs err {err} > {KERNEL_TOL}")
            lib_err = (sdpa_tri_attn(q, k, v, bias, wise).double() - ref) \
                .abs().max().item()
            del ref
            row = {
                "L": L, "wise": wise, "max_abs_err": err,
                "kernel_ms": time_ms(
                    lambda: tri_attn_core(q, k, v, bias, wise)),
                "plain_ms": time_ms(
                    lambda: tri_attn_core_plain(q, k, v, bias, wise)),
                "library_ms": time_ms(
                    lambda: sdpa_tri_attn(q, k, v, bias, wise)),
                "library_err": lib_err,
            }
            row["bound_ms"], row["bound_by"] = tri_attn_bound_ms(L, peaks)
            print("tri_attn " + json.dumps(row), flush=True)
            rows.append(row)
    return rows


def random_histograms(L: int, seed: int) -> dict:
    """Softmax-like random dist/omega/theta/phi histograms (the layout of
    tests/test_physics.py:_rand_npz)."""
    rng = np.random.default_rng(seed)

    def soft(n):
        x = rng.random((L, L, n)).astype(np.float32)
        return x / x.sum(-1, keepdims=True)
    return {"dist": soft(37), "omega": soft(25), "theta": soft(25),
            "phi": soft(13)}


def edge_queries(x: np.ndarray, shape, seed: int,
                 pair_major: bool = False) -> np.ndarray:
    """Uniform queries over [x0 - 2, x_last + 2]; every decoy's first
    queries are each knot, a point below x0, x_last and a point above.
    Decoys lead the shape, or trail it when pair_major."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(x[0] - 2.0, x[-1] + 2.0, shape).astype(np.float32)
    edges = np.concatenate([x, [x[0] - 1.0, x[-1], x[-1] + 1.5]]) \
        .astype(np.float32)
    if pair_major:
        q[:len(edges)] = edges[:, None]
    else:
        q.reshape(shape[0], -1)[:, :len(edges)] = edges
    return q


def spline_bound_ms(n_active: int, B: int, K: int, n_mask: int,
                    n_out: int, peaks) -> tuple[float, str]:
    """Least time for one call: each active query and its pair's table row
    read once, the mask and knots read once, deriv and sums written once;
    SPLINE_FLOPS float32 operations per active query."""
    nbytes = (4.0 * B * n_active + 8.0 * K * n_active + 4.0 * K + n_mask
              + 4.0 * n_out + 4.0 * B)
    t_ops = SPLINE_FLOPS * B * n_active / peaks[0]
    t_bytes = nbytes / peaks[1]
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes \
        else "bytes"


def spline_times(wrapper, plain, kernel: str) -> dict:
    """kernel_ms: the kernel's own device time (torch.profiler); wrapper_ms:
    one wrapper call back to back on the stream (CUDA events), which is
    what the fold pays per call (checks, allocation, launch, the partial
    sum); plain_ms: the plain version, the same way."""
    wrapper_ms = time_ms(wrapper)
    kernel_ms = kernel_device_ms(wrapper, kernel)
    return {"kernel_ms": wrapper_ms if kernel_ms is None else kernel_ms,
            "kernel_time_from": "events, wrapper" if kernel_ms is None
            else "profiler, kernel", "wrapper_ms": wrapper_ms,
            "plain_ms": time_ms(plain)}


def spline_kernel_phase(dev, peaks):
    """Both entries of the spline kernel against a float64 plain version,
    on tables fitted by the port's compile_restraints."""
    from trx2dy_torch.ops.spline_energy import (
        _dense_fwd, _pairs_fwd, spline_dense_plain, spline_energy_dense,
        spline_energy_pairs, spline_pairs_plain,
    )
    from trx2dy_torch.physics.compact import _compact_term
    from trx2dy_torch.physics.restraints import compile_restraints, \
        restraint_masks
    from trx2dy_torch.physics.spline import SplineTable, \
        _eval_with_deriv_pb, evaluate_spline_with_deriv

    def on(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def compare(name, sums, deriv, ref_sums, ref_deriv, abs_sums):
        check(bool(torch.isfinite(sums).all() and
                   torch.isfinite(deriv).all()), f"{name}: non-finite")
        sum_err = ((sums.double() - ref_sums).abs()
                   / abs_sums.clamp_min(1.0)).max().item()
        d_abs = (deriv.double() - ref_deriv).abs()
        deriv_err = (d_abs / ref_deriv.abs().clamp_min(1.0)).max().item()
        check(sum_err <= SPLINE_SUM_TOL,
              f"{name}: sums off by {sum_err} of sum |value|")
        check(deriv_err <= SPLINE_DERIV_TOL,
              f"{name}: deriv off by {deriv_err} x max(1, |ref|)")
        return sum_err, deriv_err, d_abs.max().item()

    rows = []
    for (B, L) in SPLINE_SHAPES:
        rst = compile_restraints(random_histograms(L, seed=L))
        masks = restraint_masks(rst, "A" * L, 1, L)
        for grid in GRIDS:
            tab, mask = getattr(rst, grid), getattr(masks, grid)
            K = tab.x.shape[0]
            y, m, x = on(tab.y), on(tab.m), on(tab.x)
            q = on(edge_queries(tab.x, (B, L, L), seed=K + L))
            mk = on(mask)
            before = spline_energy_dense.launches
            sums, deriv = _dense_fwd(y, m, x, q, mk)   # the wrapper's forward
            torch.cuda.synchronize()
            check(spline_energy_dense.launches == before + 1,
                  f"spline dense {grid}: launch counter did not advance")
            ref_sums, ref_deriv = spline_dense_plain(
                y.double(), m.double(), x.double(), q.double(), mk)
            val, _ = evaluate_spline_with_deriv(
                SplineTable(x.double(), y.double(), m.double()), q.double())
            abs_sums = torch.where(mk, val.abs(), 0.0).sum(dim=(1, 2))
            errs = compare(f"spline dense {grid} B={B} L={L}", sums, deriv,
                           ref_sums, ref_deriv, abs_sums)
            row = {"entry": "dense", "grid": grid, "B": B, "L": L, "K": K,
                   "sum_rel_err": errs[0], "deriv_err": errs[1],
                   "max_abs_err": errs[2]}
            row.update(spline_times(
                lambda: _dense_fwd(y, m, x, q, mk),
                lambda: spline_dense_plain(y, m, x, q, mk),
                "spline_dense_kernel"))
            row["bound_ms"], row["bound_by"] = spline_bound_ms(
                int(mask.sum()), B, K, L * L, B * L * L, peaks)
            print("spline " + json.dumps(row), flush=True)
            rows.append(row)

    # pair entry: the bucketed pair list of a full L=150 mask, B=50
    B, L = SPLINE_SHAPES[0]
    rst = compile_restraints(random_histograms(L, seed=L))
    idx = np.arange(L)
    full = {"dist": idx[:, None] < idx, "omega": idx[:, None] < idx,
            "theta": idx[:, None] != idx, "phi": idx[:, None] != idx}
    for grid in GRIDS:
        ct = _compact_term(getattr(rst, grid), full[grid])
        P, K = ct.y.shape
        y, m, x = on(ct.y), on(ct.m), on(ct.x)
        act = on(ct.act)
        q = on(edge_queries(ct.x, (P, B), seed=K + P, pair_major=True))
        before = spline_energy_pairs.launches
        sums, deriv = _pairs_fwd(y, m, x, q, act)
        torch.cuda.synchronize()
        check(spline_energy_pairs.launches == before + 1,
              f"spline pairs {grid}: launch counter did not advance")
        ref_sums, ref_deriv = spline_pairs_plain(
            y.double(), m.double(), x.double(), q.double(), act)
        val, _ = _eval_with_deriv_pb(y.double(), m.double(), x.double(),
                                     q.double())
        abs_sums = torch.where(act[:, None], val.abs(), 0.0).sum(dim=0)
        errs = compare(f"spline pairs {grid} P={P} B={B}", sums, deriv,
                       ref_sums, ref_deriv, abs_sums)
        row = {"entry": "pairs", "grid": grid, "B": B, "P": P, "K": K,
               "active": int(ct.act.sum()), "sum_rel_err": errs[0],
               "deriv_err": errs[1], "max_abs_err": errs[2]}
        row.update(spline_times(lambda: _pairs_fwd(y, m, x, q, act),
                                lambda: spline_pairs_plain(y, m, x, q, act),
                                "spline_pairs_kernel"))
        row["bound_ms"], row["bound_by"] = spline_bound_ms(
            int(ct.act.sum()), B, K, P, P * B, peaks)
        print("spline " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


# --------------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------------

def write_synthetic_a3m(path: Path, L: int, rows: int, seed: int) -> None:
    """A query and `rows - 1` homologs at 10-70% mutation with 10% gaps;
    every tenth homolog carries a lowercase insertion the parser strips."""
    from trx2dy_torch.io.a3m import ALPHABET
    rng = np.random.default_rng(seed)
    letters = np.array(list(ALPHABET))
    query = rng.integers(0, 20, L)
    rate = rng.uniform(0.1, 0.7, (rows, 1))
    msa = np.where(rng.random((rows, L)) < rate,
                   rng.integers(0, 20, (rows, L)), query)
    msa = np.where(rng.random((rows, L)) < 0.1, 20, msa)
    msa[0] = query
    with open(path, "w") as f:
        for n, toks in enumerate(msa):
            s = "".join(letters[toks])
            if n and n % 10 == 0:
                cut = int(rng.integers(1, L))
                s = s[:cut] + "ak" + s[cut:]
            f.write(f">seq{n}\n{s}\n")


def write_models(model_dir: Path, depth: int) -> None:
    from trx2dy_torch.dynamics.driver import WEIGHT_FILES
    from trx2dy_torch.models.convert import init_state_dict, \
        state_dict_from_flat
    model_dir.mkdir(parents=True, exist_ok=True)
    for seed, fname in enumerate(WEIGHT_FILES.values(), start=1):
        torch.save(state_dict_from_flat(init_state_dict(seed, depth)),
                   model_dir / fname)


def check_npz(path: str, L: int) -> None:
    bins = {"dist": 37, "omega": 25, "theta": 25, "phi": 13}
    with np.load(path) as f:
        check(set(f.files) == set(bins), f"{path}: keys {f.files}")
        for key, n in bins.items():
            p = f[key]
            check(p.shape == (L, L, n), f"{path}:{key} shape {p.shape}")
            check(bool(np.isfinite(p).all()), f"{path}:{key} not finite")
            check(float(np.abs(p.sum(-1) - 1).max()) < 1e-4,
                  f"{path}:{key} bins do not sum to 1")


def main_path(dev, work: Path, lengths=REQUEST_LENGTHS, rows=MSA_ROWS,
              depth=DEPTH, plain_check_L=256):
    from trx2dy_torch.dynamics.driver import geometry_stage
    from trx2dy_torch.ops.triangle_attention import tri_attn_core

    model_dir = work / "models"
    write_models(model_dir, depth)
    targets = {}
    for L in lengths:
        targets[L] = work / f"t{L}.a3m"
        write_synthetic_a3m(targets[L], L, rows, seed=L)
    per_request = 2 * 2 * depth       # two models x (row + col) x blocks

    requests, outputs = [], {}
    tri_attn_core.launches = 0
    for L in lengths:
        before = tri_attn_core.launches
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        paths = geometry_stage(f"t{L}", str(targets[L]), str(work / "out"),
                               model_dir=str(model_dir), device=dev)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launched = tri_attn_core.launches - before
        req = {"L": L, "rows": rows, "wall_s": wall,
               "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               "tri_attn_launches": launched}
        print("request " + json.dumps(req), flush=True)
        check(launched == per_request,
              f"request L={L}: {launched} kernel launches, "
              f"expected {per_request}")
        for path in paths.values():
            check_npz(path, L)
        requests.append(req)
        outputs[L] = paths
    launches = tri_attn_core.launches

    if plain_check_L in lengths:
        diff = plain_path_diff(dev, model_dir, targets[plain_check_L],
                               outputs[plain_check_L])
        print(f"plain-path check L={plain_check_L}: max abs probability "
              f"difference {diff}", flush=True)
        check(diff <= PLAIN_PATH_TOL,
              f"kernel path differs from plain path by {diff}")
    return requests, launches, outputs


def plain_path_diff(dev, model_dir: Path, a3m: Path, paths) -> float:
    """Recompute a request with every triangle attention on the plain
    version, on the card, and return the largest probability difference
    from what the kernel path saved."""
    import trx2dy_torch.models.predictor2d as p2d
    from trx2dy_torch.dynamics.driver import WEIGHT_FILES
    from trx2dy_torch.models.convert import build_model, load_params
    from trx2dy_torch.models.predictor2d_infer import predict_geometry, \
        read_msa
    from trx2dy_torch.ops.triangle_attention import tri_attn_core_plain

    kernel_core = p2d.tri_attn_core
    p2d.tri_attn_core = tri_attn_core_plain
    try:
        worst = 0.0
        for tag, path in paths.items():
            model = build_model(load_params(str(model_dir / WEIGHT_FILES[tag])),
                                dev)
            plain = predict_geometry(model, read_msa(str(a3m)))
            with np.load(path) as f:
                for key, p in plain.items():
                    worst = max(worst, float(np.abs(p - f[key]).max()))
        return worst
    finally:
        p2d.tri_attn_core = kernel_core


# --------------------------------------------------------------------------
# the main path, second half: the folder
# --------------------------------------------------------------------------

def compact_walk(L: int, seed: int) -> np.ndarray:
    """Compact self-avoiding CA walk: 3.8 A steps, >= 4 A self-clearance,
    inside a globule-sized sphere (scripts/native_recovery.py:48-71)."""
    rng = np.random.default_rng(seed)
    R = 2.9 * L ** 0.38
    pts = np.zeros((L, 3))
    i = 1
    while i < L:
        for _ in range(200):
            u = rng.normal(size=3)
            cand = pts[i - 1] + 3.8 * u / np.linalg.norm(u)
            if np.linalg.norm(cand) > R:
                continue
            if i > 3 and np.linalg.norm(
                    pts[:i - 2] - cand, axis=1).min() < 4.0:
                continue
            pts[i] = cand
            i += 1
            break
        else:
            i = max(1, i - 5)        # backtrack out of dead ends
    return pts


def synthetic_target(L: int, seed: int) -> dict:
    """Sharp dist histograms of a compact walk and uniform orientation
    histograms (scripts/native_recovery.py:89-100)."""
    walk = compact_walk(L, seed)
    d = np.linalg.norm(walk[:, None] - walk[None, :], axis=-1)
    centers = 2.25 + 0.5 * np.arange(36)          # contact bins, 2-20 A
    dist = np.exp(-0.5 * ((d[..., None] - centers) / 0.75) ** 2)
    dist = np.where(d[..., None] < 20.0, dist, 0.0)
    no_contact = (d >= 20.0).astype(np.float64)
    dist = np.concatenate([no_contact[..., None], dist], -1)
    dist /= dist.sum(-1, keepdims=True)
    uniform = {k: np.full((L, L, n), 1.0 / n, np.float32)
               for k, n in (("omega", 25), ("theta", 25), ("phi", 13))}
    return {"dist": dist.astype(np.float32), **uniform}


def centroid_energy(npz: dict, seq: str, dev):
    """(x -> (B,) centroid energies of the single mode-2 stage, restraint
    set, stage masks), prepared as fold_ensemble prepares them."""
    from trx2dy_torch.physics import compact, energy, folder, restraints
    rst = restraints.compile_restraints(npz)
    ss = restraints.disulfide_pairs(npz["dist"], seq)
    if len(ss):
        rst = restraints.add_disulfide_restraints(rst, ss)
    (masks,) = folder._stage_masks_centroid(rst, seq, 2,
                                            restraints.FoldParams().PCUT)
    cr = compact.compact_to(compact.compact_restraints(rst, masks),
                            len(seq), dev)
    w = torch.as_tensor(energy.weights_to_vec(energy.SCOREFXN_CENT),
                        device=dev)
    return (lambda x: energy.batched_energy_weighted_compact(x, cr, w)), \
        rst, masks, w


def start_torsions(seed: int, L: int, B: int, dev):
    """The (B, 3L) start torsions that fold_ensemble draws from a
    torch.Generator seeded with `seed`."""
    from trx2dy_torch.physics.folder import random_torsions
    return random_torsions(torch.Generator().manual_seed(seed), L, B) \
        .reshape(B, -1).to(dev)


@contextlib.contextmanager
def plain_splines():
    """The fold's restraint splines on their plain PyTorch version."""
    import trx2dy_torch.physics.compact as compact
    from trx2dy_torch.physics.spline import masked_spline_energy_pb
    kernel = compact.spline_energy_pairs
    compact.spline_energy_pairs = masked_spline_energy_pb
    try:
        yield
    finally:
        compact.spline_energy_pairs = kernel


def run_fold_request(label: str, L: int, B: int, fn, dev):
    """Drive fn() with every launch counter at 0 just before and read just
    after; prints and returns (fn's result, the request's numbers)."""
    from trx2dy_torch.ops.spline_energy import (
        spline_energy_dense, spline_energy_pairs,
    )
    from trx2dy_torch.physics.minimize import STATS
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    spline_energy_pairs.launches = spline_energy_dense.launches = 0
    STATS.reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    req = {"request": label, "L": L, "decoys": B, "wall_s": wall,
           "decoys_per_min": 60.0 * B / wall, "energy_evals": STATS.evals,
           "ms_per_eval": 1e3 * wall / max(STATS.evals, 1),
           "host_syncs": STATS.syncs,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "spline_pair_launches": spline_energy_pairs.launches,
           "spline_dense_launches": spline_energy_dense.launches}
    print("fold " + json.dumps(req), flush=True)
    check(STATS.evals > 0 and
          spline_energy_pairs.launches == 4 * STATS.evals,
          f"fold {label}: {spline_energy_pairs.launches} spline launches "
          f"for {STATS.evals} energy evaluations, expected 4 per evaluation")
    return out, req


def check_fold(label: str, energy, start) -> None:
    e, s = energy.double().cpu(), start.double().cpu()
    check(bool(torch.isfinite(e).all()), f"fold {label}: non-finite energy")
    check(bool((e < s).all()),
          f"fold {label}: a final energy is not below its start "
          f"({e.tolist()} vs {s.tolist()})")


def value_and_grad(fun, x):
    xg = x.detach().requires_grad_(True)
    e = fun(xg)
    (g,) = torch.autograd.grad(e.sum(), xg)
    return e.detach().double(), g.double()


def profile_chunk(fun, x0, dev) -> dict:
    """torch.profiler (device activity only, which keeps its cost down)
    over one PROFILE_ITERS-iteration L-BFGS chunk of the centroid stage
    from x0: device-busy share, kernel launches per energy evaluation, the
    five kernels with the most device time. Only device events count: the
    runtime's launch calls are listed beside them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from trx2dy_torch.physics.minimize import STATS, lbfgs_init, lbfgs_run

    st = lbfgs_run(fun, lbfgs_init(fun, x0), 2)          # warm
    torch.cuda.synchronize(dev)
    STATS.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = lbfgs_run(fun, st, PROFILE_ITERS)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=event_device_us, reverse=True)
    busy_us = sum(event_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    out = {"iterations": PROFILE_ITERS, "energy_evals": STATS.evals,
           "host_syncs": STATS.syncs, "wall_s": wall,
           "device_busy_share": busy_us / (1e6 * wall) if busy_us else None,
           "kernel_launches": launches,
           "launches_per_eval": launches / max(STATS.evals, 1),
           "top_kernels": [{"kernel": e.key[:100], "calls": e.count,
                            "device_ms": event_device_us(e) / 1e3}
                           for e in kernels[:5]]}
    print("profile " + json.dumps(out), flush=True)
    return out


def fold_phase(dev, work: Path, npz_b: str, seq_b: str):
    """Requests (a) and (b), the plain-path check of (b), the profile."""
    from trx2dy_torch.cli import fold as fold_cli
    from trx2dy_torch.io.pdbio import read_pdb_backbone
    from trx2dy_torch.physics.energy import batched_energy_fused
    from trx2dy_torch.physics.folder import fold_ensemble
    from trx2dy_torch.physics.restraints import masks_to, tables_to

    # (a) the headline: synthetic compact target, L=150, 50 decoys
    npz_a = synthetic_target(FOLD_L, seed=1)
    seq_a = "A" * FOLD_L
    energy_a, rst_a, masks_a, w_cent = centroid_energy(npz_a, seq_a, dev)
    x0_a = start_torsions(7, FOLD_L, FOLD_DECOYS, dev)
    with torch.no_grad():
        start_a = energy_a(x0_a)
    log_a = []

    def request_a():
        res = fold_ensemble(npz_a, seq_a, torch.Generator().manual_seed(7),
                            n_decoys=FOLD_DECOYS, max_iter=FOLD_ITERS,
                            fastrelax=False, use_orient=True, device=dev,
                            stage_log=log_a)
        with torch.no_grad():     # rescored through the dense entry
            fused = batched_energy_fused(
                res.torsions.reshape(FOLD_DECOYS, -1),
                tables_to(rst_a, dev), masks_to(masks_a, dev), w_cent)
        return res, fused

    (res_a, fused_a), req_a = run_fold_request("a", FOLD_L, FOLD_DECOYS,
                                               request_a, dev)
    print("stage_log a " + json.dumps(log_a), flush=True)
    check_fold("a", res_a.energy, start_a)
    check(all(0 < it <= max(FOLD_ITERS, 500) for _, it, _ in log_a),
          f"fold a: stage iterations out of range: {log_a}")
    check(req_a["spline_dense_launches"] == 4,
          "fold a: the dense rescoring did not launch 4 times")
    rescore = ((fused_a.double() - res_a.energy.double()).abs()
               / res_a.energy.double().abs()).max().item()
    print(f"fold a: dense-entry rescoring differs by {rescore} (relative)",
          flush=True)
    check(rescore <= RESCORE_TOL, f"fold a: rescoring differs by {rescore}")

    # (b) the real main path: slice 1's L=64 NMR pred_npz through the CLI
    fasta = work / "t64.fasta"
    fasta.write_text(f">t64\n{seq_b}\n")
    with np.load(npz_b) as f:
        npz = dict(f)
    energy_b, _, _, _ = centroid_energy(npz, seq_b, dev)
    x0_b = start_torsions(5, CLI_L, CLI_DECOYS, dev)
    with torch.no_grad():
        start_b = energy_b(x0_b)
    out_dir = work / "fold"
    out_dir.mkdir(exist_ok=True)

    def request_b():
        return fold_cli.main(["-NPZ", npz_b, "-FASTA", str(fasta), "-OUT",
                              str(out_dir / "t64.pdb"), "--n_decoys",
                              str(CLI_DECOYS), "--no-fastrelax", "--seed",
                              "5", "--device", str(dev)])

    (paths, res_b), req_b = run_fold_request("b", CLI_L, CLI_DECOYS,
                                             request_b, dev)
    check_fold("b", res_b.energy, start_b)
    check(len(paths) == CLI_DECOYS, f"fold b: {len(paths)} PDBs written")
    for k, path in enumerate(paths):
        coords, seq = read_pdb_backbone(path)
        ca = res_b.atoms["CA"][k].cpu().numpy()
        check(seq == seq_b and coords["CA"].shape == (CLI_L, 3),
              f"{path}: read back {len(seq)} residues")
        check(float(np.abs(coords["CA"] - ca).max()) < 1e-3,
              f"{path}: CA differs from the fold's atoms")

    # (b) held to the plain spline path on the card
    e_k, g_k = value_and_grad(energy_b, x0_b)
    e_r, g_r = value_and_grad(energy_b, x0_b)
    check(torch.equal(e_k, e_r) and torch.equal(g_k, g_r),
          "fold b: a repeated energy evaluation is not bit-identical")
    t_plain = time.perf_counter()
    with plain_splines():
        e_p, g_p = value_and_grad(energy_b, x0_b)
        res_p = fold_ensemble(npz, seq_b, None, n_decoys=CLI_DECOYS,
                              fastrelax=False, x0=x0_b, device=dev)
    t_plain = time.perf_counter() - t_plain
    first = max(((e_k - e_p).abs() / e_p.abs()).max().item(),
                ((g_k - g_p).abs().max() / g_p.abs().max()).item())
    fin_k, fin_p = (r.energy.double().cpu().numpy() for r in (res_b, res_p))
    med_k, med_p = float(np.median(fin_k)), float(np.median(fin_p))
    med = abs(med_k - med_p) / abs(med_p)
    print(f"fold b plain-path check ({t_plain:.1f} s): first energy/gradient "
          f"{first}; final medians {med_k} (kernel) vs {med_p} (plain), "
          f"{med}; means {fin_k.mean()} vs {fin_p.mean()}", flush=True)
    check(first <= FOLD_START_TOL, f"fold b: first evaluation off by {first}")
    check(med <= FOLD_MEDIAN_TOL, f"fold b: medians differ by {med}")

    prof = profile_chunk(energy_a, x0_a, dev)
    return [req_a, req_b], prof


# --------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    if not (ROOT / "trx2dy_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (the "
              "trx2dy_torch package is not beside this script)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from trx2dy_torch.device import resolve_device
    from trx2dy_torch.ops import _build

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    kind = torch.cuda.get_device_name(0)
    sheet, peaks = datasheet(kind)
    print(f"device: {kind}; bounds from the {sheet} data sheet: "
          f"{peaks[0] / 1e12:g} TFLOP/s f32, {peaks[1] / 1e12:g} TB/s",
          flush=True)
    print("versions: python %s, torch %s, cuda %s" % (
        sys.version.split()[0], torch.__version__, torch.version.cuda))

    t0 = time.perf_counter()
    logs = _build.build(["triangle_attention", "spline_energy"])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kernel_rows = kernel_phase(dev, peaks)
    print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)
    spline_rows = spline_kernel_phase(dev, peaks)
    print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        requests, launches, outputs = main_path(dev, WORK)
        print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)
        query = (WORK / f"t{CLI_L}.a3m").read_text().splitlines()[1]
        folds, prof = fold_phase(dev, WORK, outputs[CLI_L]["NMR"], query)
        print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    at_max = [r for r in kernel_rows if r["L"] == max(KERNEL_LENGTHS)]
    mean = lambda key: sum(r[key] for r in at_max) / len(at_max)
    kernels = [{
        "name": "tri_attn_fwd",
        "route": "cuda",
        "source": "trx2dy_torch/csrc/triangle_attention.cu",
        "replaces": "trx2dy/ops/triangle_attention.py:38",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": mean("kernel_ms"),
        "kernel_ms": mean("kernel_ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": at_max[0]["bound_ms"],
        "bound_by": at_max[0]["bound_by"],
        "library_ms": mean("library_ms"),
        "shape": f"L={max(KERNEL_LENGTHS)}, H={HEADS}, D={HEAD_DIM}, f32; "
                 "times are the mean of the row- and column-wise calls",
    }]
    B, L = SPLINE_SHAPES[0]
    for entry, key in (("dense", "spline_dense_launches"),
                       ("pairs", "spline_pair_launches")):
        rows = [r for r in spline_rows if r["entry"] == entry]
        main_rows = [r for r in rows if r["B"] == B
                     and r.get("L", L) == L]
        total = lambda k: sum(r[k] for r in main_rows)
        kernels.append({
            "name": f"spline_energy_{entry}",
            "route": "cuda",
            "source": "trx2dy_torch/csrc/spline_energy.cu",
            "replaces": "trx2dy/ops/spline_energy.py:27",
            "launches": sum(f[key] for f in folds),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total("kernel_ms"),
            "kernel_ms": total("kernel_ms"),
            "wrapper_ms": total("wrapper_ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in main_rows) else "operations",
            "library_ms": None,
            "library": "none: no single PyTorch call evaluates a masked "
                       "natural-cubic spline with its derivative",
            "shape": (f"B={B}, L={L}" if entry == "dense" else
                      f"B={B}, P=" + "/".join(str(r["P"]) for r in main_rows))
                     + ", f32; times and bound are the sum of one call per "
                       "knot grid (dist, omega, theta, phi: one energy "
                       "evaluation)",
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

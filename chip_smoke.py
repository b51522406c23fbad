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
     the card's data sheet gives. Triangle attention row- and column-wise
     (held to TRI_ATTN_TOL, with the bias as the trunk lays it out and as
     an (L, L, H) array); the spline restraint energy's dense entry at
     (B, L) = (50, 150) and (3, 37), its fused pair entry, all four knot
     grids in one launch, at the bucketed pair counts of a full L=150 mask
     with B=50, and its lanes entry (tables from the sampler's table
     compiler, stored once per used pool row behind a lane -> row map) at
     the bucketed pair counts of a full union with C=32 lanes at L=150
     and at phase 6's L=64, each at three lane maps (8 rows in turn,
     the initial fold's, a chain step's), with queries below, on and above
     the knots, bit-identical on a repeat and to the same tables expanded
     to one row per lane;
  4. the main path, first half: the geometry stage (a3m -> features ->
     Predictor2D at full width, depth 12, random seeded weights ->
     pred_npz for both models) answers three requests at L = 64, 256, 400
     with 1000 MSA rows. Outputs are checked for shape, finiteness and
     normalisation, and the L=256 request is recomputed on the plain path
     on the card;
  5. the main path, second half: the folder folds (a) a seeded synthetic
     compact target at L=150 into 50 decoys through fold_ensemble at its
     defaults (mode 2, max_iter 1000, orientation restraints, FastRelax's
     two rounds with the round-1 cartesian block, the final cartesian
     refinement), then packs their sidechains; (b) the L=64 NMR pred_npz
     of phase 4 into 8 decoys through the fold CLI with --no-fastrelax;
     (b') the same through the CLI with no flags but I/O, writing
     full-atom PDBs. Energies must be finite and below each decoy's start;
     the spline pair kernel must launch once per energy evaluation over
     each whole fold (the idealize pass and packing have no restraint term
     and launch nothing); (a)'s final decoys are rescored through the
     dense entry (batched_energy_fused) and must match; (a)'s CA-CA
     distances and refinement moves are reported, and the JAX package's
     refinement test is run on the card with its bands (CA_CA_BAND,
     REFINE_MOVE); packing keeps the backbone slots exactly and lowers no
     clash energy; (b')'s PDBs carry side chains and the fold's N/CA/C/O. The
     first energy and gradient of (b)'s centroid energy, of a relax-stage
     energy and of the cartesian energy are held to the plain spline path
     on the card (FOLD_START_TOL); request (b) is refolded on the plain
     path, final energy medians within FOLD_MEDIAN_TOL; a repeated
     evaluation must be bit-identical (the fold is deterministic). One
     L-BFGS chunk (PROFILE_ITERS iterations) each of the centroid, relax
     and cartesian energies is profiled;
  6. the whole pipeline, run_single through its CLI
     (python -m trx2dy_torch.cli.run_inference with --fasta, --msa,
     --model_dir, --save_dir, --name and --Nmax RUN_NMAX, every other flag
     at its default: both models combined, 8 chains a model, a 32-lane
     bucket, FastRelax, full-atom output) at L=64 on phase 4's a3m and
     weights. Checked: 2 x 10 initial decoys and the chain decoys renamed
     conf_1_* / conf_2_* with side chains, tmp_npz gone, traces.jsonl's
     phase rows, one lanes-entry launch per spline-counted evaluation; on
     a chain step's tables (the predicted histograms dampened by written
     initial decoys, compiled as the driver compiles them) the first
     energy and gradient held to the plain spline path (FOLD_START_TOL), a
     repeated evaluation bit-identical, the dampened histograms normalised
     on the dampened pairs (DAMPEN_NORM_TOL), and one L-BFGS chunk of
     that energy profiled (the union chunk). The initial fold's and each
     step's wall (fold, emit, measure), decoys per minute, evaluations, ms
     per evaluation, host syncs per step and peak memory are printed;
  7. the analysis layer and the host chain fold: fold (a)'s 50 decoys
     scored by the device TM-score engine (tm_score_batch) against the
     compact walk behind their histograms (the walk gives the CB-CB
     distances, so the decoys' CB traces), each pair held to the native
     engine (NATIVE_TM_TOL, RMSD_TOL); the (50, 50) TM and
     RMSD matrices of their CA traces by the device engine over the 1225
     pairs and by the native engine, held alike and timed; the cluster CLI
     (python -m trx2dy_torch.cli.cluster, called in this process) on phase
     6's 24 conf_* PDBs in the glocon, tmscore and rmsd modes with
     --n_clusters CLUSTERS, its copies checked; the evaluate CLI with two
     of (b')'s full-atom decoys as natives and phase 6's conf_* as
     predictions, its summary.txt checked (two native lines, four
     statistics); then fold_chains at L=64 on 4 chains from each model's
     pred_npz of phase 4, CHAIN_CANDIDATES candidates a chain, a 32-lane
     bucket, mode 2, FastRelax and the cartesian refinement, max_iter
     CHAIN_FOLD_ITERS: one lanes-entry launch per spline-counted
     evaluation, the first energy and gradient held to the plain spline
     path (FOLD_START_TOL), a repeated evaluation bit-identical, finite
     energies below their starts, each chain's pick the argmin of its
     candidates; wall, evaluations, ms per evaluation, host syncs and
     peak memory printed;
     Phase 5 ends with (b')'s fold again with folder.REPACK_IN_LOOP on
     (relax round 2 as fa_stage, the in-loop repack): one pair launch per
     spline-counted evaluation, energies finite and below each start,
     the first fa_stage energy and gradient held to the plain spline path
     (FOLD_START_TOL); its wall and packed clash energy beside (b')'s
     with the switch off (line `repack`); the switch is restored;
  8. the e2e static predictor through its CLI (python -m
     trx2dy_torch.cli.predict, called in this process) at full width on
     seeded random weights written once in the published formats
     (model_1.pth.tar, the fairseq esm_msa1_t12_100M_UR50S.pt, which the
     CLI upgrades as it loads): a synthetic a3m of E2E_ROWS rows at
     L = E2E_L, filtered to filter500.a3m, -nrows 500 -nrec 3; at the
     CLI's default (bf16 weights) and with --no-bf16, each exactly
     E2E_LAUNCHES triangle attention launches, the four files checked
     (probability maps of 37/25/25/13 bins summing to 1 within
     E2E_NORM_TOL, pLDDT finite in [0, 1], a PDB of L residues with pLDDT
     B-factors, plddt.csv); the float32 run recomputed with the plain
     attention on the card: probabilities within PLAIN_PATH_TOL, pLDDT
     within E2E_PLDDT_TOL, CA within E2E_CA_TOL; the kernel held to
     float64 within TRI_ATTN_TOL x max(1, max |v|) on the first and the
     last float32 inputs the bf16 run gave it; reported: the bf16 run
     against float32 and against itself on the plain attention, and each
     map's saturation (median largest probability, share of pairs whose
     most probable bin differs). Wall per run split into MSA filter,
     weights, ESM forward, features, each cycle's trunk and structure
     module, and writing, peak memory, and the attention kernel's share of
     the device time of a float32 trunk forward traced by torch.profiler
     (lines `e2e`, `e2e check`);
  9. a `kernels` JSON line, then {"ok": true, "device": {...}} last.

Launch counts are set to 0 just before each request of phases 4 to 8 and
read just after it; a kernel of a path that did not launch fails the run.

It exits non-zero, printing no result, where CUDA is unavailable or the
port is not beside it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
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
# triangle attention against float64: the kernel keeps float32 accuracy
# (3xTF32); single-pass TF32 would be ~1e-3 off and must fail here
TRI_ATTN_TOL = 1e-5
PLAIN_PATH_TOL = 1e-3      # probabilities, kernel path vs plain path
HEADS, HEAD_DIM = 4, 32

SPLINE_SHAPES = ((50, 150), (3, 37))   # dense entry (B, L)
SPLINE_SUM_TOL = 1e-5      # per-decoy sums, relative to sum |value|
SPLINE_DERIV_TOL = 1e-4    # dE/dq, times max(1, |reference|)
SPLINE_FLOPS = 40          # per active query: search, cubic, derivative
GRIDS = ("dist", "omega", "theta", "phi")
FOLD_L, FOLD_DECOYS, FOLD_ITERS = 150, 50, 1000   # headline request (a)
CLI_L, CLI_DECOYS = 64, 8                          # requests (b), (b')
CHAIN_LANES = 32           # the sampler's lane bucket at its defaults
RUN_NMAX = 2               # phase 6's depth (decoys per chain model)
DAMPEN_NORM_TOL = 1e-4     # dampened bins' sum on dampened pairs
FOLD_START_TOL = 1e-4      # first energy and gradient, kernel vs plain path
# final energy medians, kernel vs plain path. The fold is deterministic,
# but the two paths' trajectories diverge from rounding, and which decoys
# land in which minimum moves a median of 8: the two medians differed by
# 3.8 % (means 1.6 %) in a deterministic run of this script (PERF.md)
FOLD_MEDIAN_TOL = 0.10
RESCORE_TOL = 1e-4         # dense-entry rescoring vs the fold's energies
# L-BFGS iterations of a profiled chunk (the cartesian block's first
# stage; a centroid STAGE_CHUNK is 250): processing the trace of 250
# centroid iterations (~500k kernel events) took ~100 s of host time
PROFILE_ITERS = 50
# the JAX package's refinement bands (tests/test_physics.py:489-507,
# 842-860), held on the inputs of those tests (refine_band_phase)
CA_CA_BAND = (2.7, 4.2)    # consecutive CA-CA distances (A)
REFINE_MOVE = 1.5          # refined CA from where it started, at most (A)
CLASH_TOL = 1e-3           # packed clash energy <= start + CLASH_TOL
# phase 7: the device TM-score engine against the native one. The device
# engine runs every round of each seed's search where the native one stops
# once the selection fixes or fewer than 4 residues pass, so its TM is
# not lower, and the two agree within NATIVE_TM_TOL where TM >=
# NATIVE_TM_FROM; RMSD (Kabsch over every residue) within RMSD_TOL x
# max(1, RMSD). From the CPU tests (tests/test_torch_tmscore.py): equal to
# 2e-7 at TM >= 0.7, 4.9e-4 apart at TM 0.42-0.49, up to 0.037 higher at
# TM 0.06-0.11. Float32 can flip a residue at the cutoff where the native
# engine's float64 does not, so a pair may end a little lower: 2.2e-5 in
# the all-vs-all on the card (PERF.md), held to NATIVE_TM_TOL.
NATIVE_TM_TOL = 1e-3
NATIVE_TM_FROM = 0.5
RMSD_TOL = 1e-4
CLUSTERS = 4               # --n_clusters of the cluster CLI
# the chain fold: 4 chains from each model's L=64 pred_npz, 2 candidates a
# chain, the sampler's 32-lane bucket, mode 2 with FastRelax and the
# cartesian refinement; max_iter, the centroid stages' budget, is the one
# depth cut: 300 took 85.5 s on a host where fold (a) took 159 s, and the
# chip hosts differ by up to 2x (PERF.md), so 150 keeps it near 90 s
CHAIN_NPZ_CHAINS, CHAIN_CANDIDATES, CHAIN_FOLD_ITERS = 4, 2, 150
# phase 8, the e2e predictor at full width: ESM-MSA-1b at 12 x 768 x 12
# heads, Folding at dim 128, depth 12, 8 structure-module blocks, 12 IPA
# heads, on a synthetic a3m of E2E_ROWS rows at L = E2E_L filtered to
# E2E_NROWS, E2E_RECYCLES recycles: 2 attentions x 12 blocks x 4 cycles
E2E_L, E2E_ROWS, E2E_NROWS, E2E_RECYCLES = 256, 1000, 500, 3
E2E_LAUNCHES = 2 * DEPTH * (1 + E2E_RECYCLES)
E2E_NORM_TOL = 1e-5        # probability maps sum to 1
E2E_PLDDT_TOL = 1e-3       # pLDDT, kernel path vs plain path (f32)
# CA coordinates (A), kernel path vs plain path (f32): the 8 IPA blocks
# and 4 cycles amplify the attention core's float32 rounding on random
# weights; 1.1e-3 A apart on an H100 (PERF.md)
E2E_CA_TOL = 0.01

# Data-sheet peaks: float32 outside the tensor cores, memory rate, dense
# TF32 on the tensor cores.
DATASHEETS = {
    "H100 PCIe": (51e12, 2.0e12, 378e12),
    "H100 NVL": (60e12, 3.9e12, 417e12),
    "H200": (67e12, 4.8e12, 495e12),
    "H100 SXM": (67e12, 3.35e12, 495e12),
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
    projection), and the (L, L, H) bias as the trunk makes it: a view of a
    head-major (H, L, L) array."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(L, L, 3 * HEADS * HEAD_DIM, generator=gen).to(dev)
    q, k, v = (t.reshape(L, L, HEADS, HEAD_DIM)
               for t in torch.chunk(qkv, 3, dim=-1))
    bias = torch.randn(HEADS, L, L, generator=gen).to(dev).permute(1, 2, 0)
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


def tri_attn_bound_ms(L: int, peaks) -> tuple[float, str, float]:
    """(bound, what bounds it, the 3xTF32 bound): the function's float32
    operations at the f32 rate, or its bytes, whichever takes longer; and
    the three TF32 products per product the kernel runs, at the dense TF32
    rate."""
    flops = 4.0 * L ** 3 * HEADS * HEAD_DIM          # q.k and p.v products
    nbytes = 4.0 * (4 * L * L * HEADS * HEAD_DIM     # q, k, v in; out
                    + L * L * HEADS)                 # bias
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    t_tf32 = max(3.0 * flops / peaks[2], t_bytes)
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes \
        else "bytes", 1e3 * t_tf32


def kernel_phase(dev, peaks, lengths=KERNEL_LENGTHS):
    from trx2dy_torch.ops.triangle_attention import (
        tri_attn_core, tri_attn_core_plain)
    rows = []
    for L in lengths:
        q, k, v, bias = tri_attn_inputs(L, dev, seed=L)
        bias_ijh = bias.contiguous()                 # (L, L, H) layout
        for wise in ("row", "col"):
            before = tri_attn_core.launches
            out = tri_attn_core(q, k, v, bias, wise)
            out_ijh = tri_attn_core(q, k, v, bias_ijh, wise)
            torch.cuda.synchronize()
            check(tri_attn_core.launches == before + 2,
                  f"tri_attn L={L} {wise}: launch counter did not advance")
            ref = tri_attn_core_plain(q.double(), k.double(), v.double(),
                                      bias.double(), wise)
            check(bool(torch.isfinite(out).all()),
                  f"tri_attn L={L} {wise}: non-finite output")
            err = max((o.double() - ref).abs().max().item()
                      for o in (out, out_ijh))
            check(err <= TRI_ATTN_TOL,
                  f"tri_attn L={L} {wise}: max abs err {err} > "
                  f"{TRI_ATTN_TOL}")
            lib_err = (sdpa_tri_attn(q, k, v, bias, wise).double() - ref) \
                .abs().max().item()
            del ref
            row = {
                "L": L, "wise": wise, "max_abs_err": err,
                "kernel_ms": time_ms(
                    lambda: tri_attn_core(q, k, v, bias, wise)),
                "kernel_ms_ijh_bias": time_ms(
                    lambda: tri_attn_core(q, k, v, bias_ijh, wise)),
                "plain_ms": time_ms(
                    lambda: tri_attn_core_plain(q, k, v, bias, wise)),
                "library_ms": time_ms(
                    lambda: sdpa_tri_attn(q, k, v, bias, wise)),
                "library_err": lib_err,
            }
            row["bound_ms"], row["bound_by"], row["bound_ms_3xtf32"] = \
                tri_attn_bound_ms(L, peaks)
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
    what the fold pays per call (checks, allocation, launch, and for the
    dense entry the partial sum); plain_ms: the plain version, the same
    way."""
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
        SplinePairs, _dense_fwd, _pairs_fwd, spline_dense_plain,
        spline_energy_dense, spline_energy_pairs, spline_pairs_plain,
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

    # fused pair entry: the bucketed pair lists of a full L=150 mask, B=50,
    # all four grids in one launch, as one energy evaluation of the fold
    B, L = SPLINE_SHAPES[0]
    rst = compile_restraints(random_histograms(L, seed=L))
    idx = np.arange(L)
    full = {"dist": idx[:, None] < idx, "omega": idx[:, None] < idx,
            "theta": idx[:, None] != idx, "phi": idx[:, None] != idx}
    terms, qs, active = [], [], []
    for grid in GRIDS:
        ct = _compact_term(getattr(rst, grid), full[grid])
        P, K = ct.y.shape
        terms.append((on(ct.y), on(ct.m), on(ct.x), on(ct.act)))
        qs.append(on(edge_queries(ct.x, (P, B), seed=K + P, pair_major=True)))
        active.append(int(ct.act.sum()))
    tables = SplinePairs(terms)
    before = spline_energy_pairs.launches
    sums, derivs = _pairs_fwd(tables, qs)
    torch.cuda.synchronize()
    check(spline_energy_pairs.launches == before + 1,
          "spline pairs: launch counter did not advance")
    terms64 = [(y.double(), m.double(), x.double(), act)
               for y, m, x, act in terms]
    ref_sums, ref_derivs = spline_pairs_plain(terms64,
                                              [q.double() for q in qs])
    row = {"entry": "pairs", "grids": list(GRIDS), "B": B,
           "P": [t[0].shape[0] for t in terms],
           "K": [t[2].shape[0] for t in terms], "active": active,
           "sum_rel_err": [], "deriv_err": [], "max_abs_err": 0.0}
    for n, grid in enumerate(GRIDS):
        y, m, x, act = terms64[n]
        val, _ = _eval_with_deriv_pb(y, m, x, qs[n].double())
        abs_sums = torch.where(act[:, None], val.abs(), 0.0).sum(dim=0)
        errs = compare(f"spline pairs {grid} P={row['P'][n]} B={B}",
                       sums[n], derivs[n], ref_sums[n], ref_derivs[n],
                       abs_sums)
        row["sum_rel_err"].append(errs[0])
        row["deriv_err"].append(errs[1])
        row["max_abs_err"] = max(row["max_abs_err"], errs[2])
    # bit-identical on a repeat: the in-kernel sum has a fixed order
    sums2, derivs2 = _pairs_fwd(tables, qs)
    check(torch.equal(sums, sums2) and all(
        torch.equal(a, b) for a, b in zip(derivs, derivs2)),
        "spline pairs: a repeated launch is not bit-identical")
    row.update(spline_times(lambda: _pairs_fwd(tables, qs),
                            lambda: spline_pairs_plain(terms, qs),
                            "spline_pairs_kernel"))
    bounds = [spline_bound_ms(n_act, B, t[2].shape[0], t[0].shape[0],
                              t[0].shape[0] * B, peaks)
              for n_act, t in zip(active, terms)]
    row["bound_ms"] = sum(b for b, _ in bounds)
    row["bound_by"] = "bytes" if all(by == "bytes" for _, by in bounds) \
        else "operations"
    print("spline " + json.dumps(row), flush=True)
    rows.append(row)
    for L in (SPLINE_SHAPES[0][1], CLI_L):     # the smoke's L and phase 6's
        rows += spline_lanes_check(dev, peaks, on, compare, L)
    return rows


def lane_maps(C: int = CHAIN_LANES) -> dict:
    """The lanes entry's lane -> pool-row maps over a pool of 2 x 8 chain
    histograms: 8 rows in turn (cyclic); the initial fold's (each
    model's first chain fanned out to 13 lanes, padded to C with the last,
    driver.py's init_map through folder.fold_chains_pool); a chain step's
    (16 chains x 2 candidates)."""
    init = np.repeat([0, 8], 13)
    return {
        "cyclic": np.arange(C) % 8,
        "initial": np.concatenate([init, np.full(C - len(init), init[-1])]),
        "chain": np.repeat(np.arange(16), C // 16),
    }


def distinct_intervals(x: np.ndarray, U: int, row: np.ndarray,
                       q: np.ndarray, act: np.ndarray) -> int:
    """Distinct (pair, table row, interval) of the active queries q (P, C):
    the float4 table entries this data needs (clip(#{x[:K-1] <= q} - 1, 0,
    K-2), the kernel's interval)."""
    K = len(x)
    k = np.clip(np.searchsorted(x[:K - 1], q, side="right") - 1, 0, K - 2)
    p = np.broadcast_to(np.arange(q.shape[0])[:, None], q.shape)
    key = (p * U + row[None, :]).astype(np.int64) * (K - 1) + k
    return int(np.unique(key[act]).size)


def spline_lanes_bound_ms(P: int, C: int, n_active: int, n_tab: int, K: int,
                          peaks) -> tuple[float, str, float]:
    """Least time for one term of the lanes entry: each (pair, lane)'s
    query and activity read and derivative written once, the lane -> row
    map, knots and sums, and 16 bytes for each distinct (pair, row,
    interval) an active query touches (n_tab, what this data needs of the
    stored tables); SPLINE_FLOPS float32 operations per active query.
    Returns (bound, what bounds it, the per-query byte bound, which counts 16
    bytes per active query, the per-lane tables' need)."""
    fixed = 9.0 * P * C + 4.0 * K + 4.0 * C
    t_ops = SPLINE_FLOPS * n_active / peaks[0]
    t_bytes = (fixed + 4.0 * C + 16.0 * n_tab) / peaks[1]
    t_query = (fixed + 16.0 * n_active) / peaks[1]
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes \
        else "bytes", 1e3 * max(t_ops, t_query)


def spline_lanes_check(dev, peaks, on, compare, L: int) -> list:
    """The lanes entry against a float64 plain version at each lane map
    (lane_maps): tables from the sampler's table compiler over 16 random
    histograms of length L (a full union, the bucketed pair counts) for
    C=CHAIN_LANES lanes, the relax round-2 activity thinned at random per
    lane, queries below, on and above the knots, all four grids in one
    launch. Each launch is bit-identical on a repeat and to a launch over
    the tables expanded to one row per lane under the identity map."""
    from trx2dy_torch.ops.spline_energy import (
        SplineLanes, _lanes_fwd, expand_lane_tables, spline_energy_lanes,
        spline_lanes_plain,
    )
    from trx2dy_torch.physics.compact import _bucket
    from trx2dy_torch.physics.spline import SplineTable, \
        evaluate_spline_with_deriv
    from trx2dy_torch.physics.tablegen import union_compiler

    C, U = CHAIN_LANES, 16
    hists = [random_histograms(L, seed=L + u) for u in range(U)]
    pool = {k: on(np.stack([h[k] for h in hists])) for k in GRIDS}
    del hists
    comp = union_compiler("A" * L, device=dev)
    counts = comp.count(pool)[0].tolist()
    P = tuple(_bucket(int(c)) for c in counts)
    rows = []
    for name, lane_map in lane_maps(C).items():
        ur, _, _, r2 = comp.compile(pool, lane_map, P)
        rng = np.random.default_rng(5)
        terms, qs, active, n_tab = [], [], [], []
        for t, a in zip(ur, r2):
            act = (a & on(rng.random(tuple(a.shape)) < 0.8)).contiguous()
            terms.append((t.tab, t.row, t.x, act))
            x = t.x.cpu().numpy()
            q = edge_queries(x, (t.tab.shape[0], C), seed=len(x) + 7,
                             pair_major=True)
            qs.append(on(q))
            act_np = act.cpu().numpy()
            active.append(int(act_np.sum()))
            n_tab.append(distinct_intervals(x, t.tab.shape[1],
                                            t.row.cpu().numpy(), q, act_np))
        tables = SplineLanes(terms)
        before = spline_energy_lanes.launches
        sums, derivs = _lanes_fwd(tables, qs)
        torch.cuda.synchronize()
        check(spline_energy_lanes.launches == before + 1,
              "spline lanes: launch counter did not advance")
        terms64 = [(tab.double(), row, x.double(), act)
                   for tab, row, x, act in terms]
        qs64 = [q.double() for q in qs]
        ref_sums, ref_derivs = spline_lanes_plain(terms64, qs64)
        row = {"entry": "lanes", "map": name, "grids": list(GRIDS), "C": C,
               "L": L, "P": list(P), "K": [t[2].shape[0] for t in terms],
               "rows": ur.dist.tab.shape[1],
               "table_mb": sum(t.tab.numel() * 4 for t in ur) / 1e6,
               "active": active, "distinct_intervals": n_tab,
               "sum_rel_err": [], "deriv_err": [], "max_abs_err": 0.0}
        for n, grid in enumerate(GRIDS):
            tab, lane_row, x, act = terms64[n]
            y, m = expand_lane_tables(tab, lane_row)
            val, _ = evaluate_spline_with_deriv(SplineTable(x, y, m),
                                                qs64[n])
            abs_sums = torch.where(act, val.abs(), 0.0).sum(dim=0)
            del y, m, val
            errs = compare(f"spline lanes {name} {grid} L={L} C={C}",
                           sums[n], derivs[n], ref_sums[n], ref_derivs[n],
                           abs_sums)
            row["sum_rel_err"].append(errs[0])
            row["deriv_err"].append(errs[1])
            row["max_abs_err"] = max(row["max_abs_err"], errs[2])
        del terms64, qs64, ref_sums, ref_derivs
        sums2, derivs2 = _lanes_fwd(tables, qs)
        check(torch.equal(sums, sums2) and all(
            torch.equal(a, b) for a, b in zip(derivs, derivs2)),
            f"spline lanes {name} L={L}: a repeated launch is not "
            "bit-identical")
        ident = torch.arange(C, dtype=torch.int32, device=dev)
        expanded = SplineLanes([
            (tab.index_select(1, row.long()).contiguous(), ident, x, act)
            for tab, row, x, act in terms])
        sums3, derivs3 = _lanes_fwd(expanded, qs)
        check(torch.equal(sums, sums3) and all(
            torch.equal(a, b) for a, b in zip(derivs, derivs3)),
            f"spline lanes {name} L={L}: the identity map over expanded "
            "tables is not bit-identical to the shared-row launch")
        del expanded, sums3, derivs3
        row.update(spline_times(lambda: _lanes_fwd(tables, qs),
                                lambda: spline_lanes_plain(terms, qs),
                                "spline_pairs_kernel"))
        bounds = [spline_lanes_bound_ms(P_t, C, n_act, n_t, t[2].shape[0],
                                        peaks)
                  for P_t, n_act, n_t, t in zip(P, active, n_tab, terms)]
        row["bound_ms"] = sum(b[0] for b in bounds)
        row["bound_by"] = "bytes" if all(b[1] == "bytes" for b in bounds) \
            else "operations"
        row["bound_ms_per_query"] = sum(b[2] for b in bounds)
        print("spline " + json.dumps(row), flush=True)
        rows.append(row)
        del ur, r2, terms, tables
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
    """The fold's and the sampler's restraint splines on their plain
    PyTorch versions (the lanes entry's per JAX's lane-major layout, its
    tables expanded to one per lane)."""
    import trx2dy_torch.physics.compact as compact
    from trx2dy_torch.ops.spline_energy import expand_lane_tables
    from trx2dy_torch.physics.spline import masked_spline_energy_lanes, \
        masked_spline_energy_pb

    def plain(tables, qs):
        return torch.stack([masked_spline_energy_pb(y, m, x, q, act)
                            for (y, m, x, act), q in zip(tables.terms, qs)])

    def plain_lanes(tables, qs):
        out = []
        for (tab, row, x, act), q in zip(tables.terms, qs):
            y, m = expand_lane_tables(tab, row)
            out.append(masked_spline_energy_lanes(
                y.transpose(0, 1), m.transpose(0, 1), x, q.T, act.T))
        return torch.stack(out)
    kernels = compact.spline_energy_pairs, compact.spline_energy_lanes
    compact.spline_energy_pairs = plain
    compact.spline_energy_lanes = plain_lanes
    try:
        yield
    finally:
        compact.spline_energy_pairs, compact.spline_energy_lanes = kernels


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
           "restraint_free_evals": STATS.free_evals,
           "host_syncs": STATS.syncs,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "spline_pair_launches": spline_energy_pairs.launches,
           "spline_dense_launches": spline_energy_dense.launches}
    print("fold " + json.dumps(req), flush=True)
    check(STATS.evals > 0 and
          spline_energy_pairs.launches == STATS.evals,
          f"fold {label}: {spline_energy_pairs.launches} spline launches "
          f"for {STATS.evals} energy evaluations, expected 1 per evaluation")
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


def profile_chunk(fun, x0, dev, iters: int = PROFILE_ITERS,
                  label: str = "centroid") -> dict:
    """torch.profiler (device activity only, which keeps its cost down)
    over one L-BFGS chunk of up to `iters` iterations of fun from x0:
    device-busy share, kernel launches per energy evaluation, the five
    kernels with the most device time. Only device events count: the
    runtime's launch calls are listed beside them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from trx2dy_torch.physics.minimize import STATS, lbfgs_init, lbfgs_run

    st = lbfgs_run(fun, lbfgs_init(fun, x0), 2)          # warm
    torch.cuda.synchronize(dev)
    k0 = st.k
    STATS.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = lbfgs_run(fun, st, iters)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=event_device_us, reverse=True)
    busy_us = sum(event_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    out = {"chunk": label, "iterations": st.k - k0,
           "energy_evals": STATS.evals, "host_syncs": STATS.syncs,
           "wall_s": wall,
           "ms_per_eval": 1e3 * wall / max(STATS.evals, 1),
           "device_busy_share": busy_us / (1e6 * wall) if busy_us else None,
           "kernel_launches": launches,
           "launches_per_eval": launches / max(STATS.evals, 1),
           "top_kernels": [{"kernel": e.key[:100], "calls": e.count,
                            "device_ms": event_device_us(e) / 1e3}
                           for e in kernels[:5]]}
    print("profile " + json.dumps(out), flush=True)
    return out


def synthetic_sequence(L: int, seed: int) -> str:
    """A seeded sequence of the 18 amino acids other than GLY and CYS: the
    sidechains give packing real work, while the fold is the one an
    all-ALA sequence gets (no glycine pair leaves the relax restraints, no
    disulfide is detected)."""
    letters = np.array(list("ADEFHIKLMNPQRSTVWY"))
    return "".join(np.random.default_rng(seed).choice(letters, L))


def relax_energies(npz: dict, seq: str, dev):
    """(the relax-round-1 energy x -> (B,) with the first ramp stage's
    weights, the relax-2 tables, the full relax weights), prepared as
    fold_ensemble prepares them."""
    from trx2dy_torch.physics import compact, energy, folder, restraints
    rst = restraints.compile_restraints(npz)
    L = len(seq)
    r1, r2 = (compact.compact_to(compact.compact_restraints(
        rst, restraints.restraint_masks(rst, seq, 1, L, pcut=pc,
                                        nogly=True)), L, dev)
        for pc in (0.15, 0.30))
    fa, cst, _ = folder.RELAX_SCHEDULE_R1[0]
    w1 = torch.as_tensor(energy.weights_to_vec(
        folder._ramped_relax_weights(fa, cst)), device=dev)
    w_full = torch.as_tensor(energy.weights_to_vec(folder.SCOREFXN_RELAX),
                             device=dev)
    return (lambda x: energy.batched_energy_weighted_compact(x, r1, w1)), \
        r2, w_full


def check_kernel_vs_plain(label: str, fun, x) -> float:
    """First value and gradient of fun at x through the kernel and on the
    plain spline path: their largest relative difference, held to
    FOLD_START_TOL."""
    e_k, g_k = value_and_grad(fun, x)
    with plain_splines():
        e_p, g_p = value_and_grad(fun, x)
    diff = max(((e_k - e_p).abs() / e_p.abs()).max().item(),
               ((g_k - g_p).abs().max() / g_p.abs().max()).item())
    print(f"{label} plain-path check: first energy/gradient {diff}",
          flush=True)
    check(diff <= FOLD_START_TOL, f"{label}: first evaluation off by {diff}")
    return diff


def check_decoys(label: str, res, refined: bool) -> dict:
    """Finite atoms; the CA-CA distances and the largest CA move of the
    refined atoms from the NeRF build of the returned torsions, reported
    (on a target with restraints this sharp the JAX package's refinement
    leaves both bands too: scripts/refine_band_check.py); the atoms moved
    at all only if refined."""
    from trx2dy_torch.geometry.nerf import build_backbone
    check(all(bool(torch.isfinite(a).all()) for a in res.atoms.values()),
          f"fold {label}: non-finite atoms")
    ca = res.atoms["CA"].double()
    d = torch.linalg.vector_norm(ca[:, 1:] - ca[:, :-1], dim=-1)
    t = res.torsions
    with torch.no_grad():
        ideal = build_backbone(t[:, 0], t[:, 1], t[:, 2])
    move = torch.linalg.vector_norm(res.atoms["CA"] - ideal["CA"], dim=-1)
    out = {"ca_ca_min": d.min().item(), "ca_ca_max": d.max().item(),
           "ca_ca_outside_band": int(((d <= CA_CA_BAND[0])
                                      | (d >= CA_CA_BAND[1])).sum()),
           "refine_ca_move_max": move.max().item(),
           "refine_ca_move_median": move.amax(1).median().item()}
    print(f"decoys {label} " + json.dumps(out), flush=True)
    check((out["refine_ca_move_max"] > 0) == refined,
          f"fold {label}: refined atoms moved {move.max().item()} A")
    return out


def refine_band_phase(dev) -> dict:
    """The JAX package's own refinement test (tests/test_physics.py:
    TestCartesianRefine) on the card: a random-histogram L=14 target folded
    without relax (30 iterations, 2 decoys), refined with the dense and the
    compact tables (60 iterations) against the pcut 0.30 relax set: the
    energy no higher than the start's, every CA within REFINE_MOVE of where
    it was, CA-CA distances in CA_CA_BAND."""
    from trx2dy_torch.physics import cartmin, compact, restraints
    from trx2dy_torch.physics.energy import weights_to_vec
    from trx2dy_torch.physics.folder import SCOREFXN_RELAX, fold_ensemble
    L, seq = 14, "ARNDCQEGHILKMF"
    npz = random_histograms(L, seed=91)
    res = fold_ensemble(npz, seq, torch.Generator().manual_seed(1),
                        n_decoys=2, max_iter=30, fastrelax=False, device=dev)
    rst = restraints.compile_restraints(npz)
    masks = restraints.restraint_masks(rst, seq, 1, L, pcut=0.30, nogly=True)
    cr = compact.compact_to(compact.compact_restraints(rst, masks), L, dev)
    w = torch.as_tensor(weights_to_vec(SCOREFXN_RELAX), device=dev)
    with torch.no_grad():
        e0 = cartmin._cart_efun(res.atoms, cr, w, "compact")(
            torch.zeros(2, 15 * L, device=dev))
    out = {"start_energy": e0.tolist()}
    for kind, refine in (
            ("dense", lambda: cartmin.cartesian_refine(
                res.atoms, rst, masks, SCOREFXN_RELAX, max_iter=60)),
            ("compact", lambda: cartmin.cartesian_refine_compact(
                res.atoms, cr, SCOREFXN_RELAX, max_iter=60))):
        atoms, f = refine()
        move = (atoms["CA"] - res.atoms["CA"]).abs().max().item()
        d = torch.linalg.vector_norm(atoms["CA"][:, 1:]
                                     - atoms["CA"][:, :-1], dim=-1)
        out[kind] = {"energy": f.tolist(), "ca_move_max": move,
                     "ca_ca_min": d.min().item(), "ca_ca_max": d.max().item()}
        check(bool(torch.isfinite(f).all() and (f <= e0 + 1e-3).all()),
              f"refine band {kind}: energy {f.tolist()} above the start's")
        check(move < REFINE_MOVE, f"refine band {kind}: CA moved {move} A")
        check(CA_CA_BAND[0] < out[kind]["ca_ca_min"] and
              out[kind]["ca_ca_max"] < CA_CA_BAND[1],
              f"refine band {kind}: CA-CA distances {out[kind]}")
    print("refine band " + json.dumps(out), flush=True)
    return out


def pack_phase(res, seq: str, dev) -> dict:
    """pack_ensemble on the fold's decoys, onto its refined atoms: time,
    peak memory, the clash energy before (staggered start) and after."""
    from trx2dy_torch.physics import sidechain
    from trx2dy_torch.physics.minimize import STATS
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    STATS.reset()
    t0 = time.perf_counter()
    xyz, mask, chi = sidechain.pack_ensemble(res.torsions, seq,
                                             backbone=res.atoms, device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    pin = sidechain.pack_input(seq, dev)
    chi0 = torch.full_like(chi, np.pi) * pin.chi_mask
    with torch.no_grad():
        start, _, _ = sidechain.atom14_from_torsions(
            res.torsions, chi0, pin, backbone=res.atoms)
        before = sidechain._clash_energy(start, pin)
        after = sidechain._clash_energy(xyz, pin)
    out = {"decoys": xyz.shape[0], "L": xyz.shape[1], "wall_s": wall,
           "peak_mem_gib": peak, "pack_evals": STATS.free_evals,
           "spline_evals": STATS.evals, "host_syncs": STATS.syncs,
           "clash_before_median": before.median().item(),
           "clash_after_median": after.median().item()}
    print("pack " + json.dumps(out), flush=True)
    check(bool(torch.isfinite(xyz).all()), "pack: non-finite atom14")
    for name, slot in sidechain._BB_SLOTS.items():
        check(torch.equal(xyz[:, :, slot], res.atoms[name]),
              f"pack: backbone slot {name} differs from the fold's atoms")
    check(bool((after <= before + CLASH_TOL).all()),
          f"pack: clash rose ({before.tolist()} -> {after.tolist()})")
    check(STATS.evals == 0, "pack: an evaluation with a restraint term")
    return out


def fold_phase(dev, work: Path, npz_b: str, seq_b: str):
    """Requests (a), (b) and (b'), packing (a)'s decoys, the plain-path
    checks, the profiles."""
    from trx2dy_torch.cli import fold as fold_cli
    from trx2dy_torch.io.pdbio import read_pdb_backbone
    from trx2dy_torch.physics import cartmin
    from trx2dy_torch.physics.energy import batched_energy_fused
    from trx2dy_torch.geometry.nerf import build_backbone
    from trx2dy_torch.physics.folder import fold_ensemble
    from trx2dy_torch.physics.restraints import masks_to, tables_to

    # (a) the headline: synthetic compact target, L=150, 50 decoys, the
    # default protocol (relax, cartesian block and refinement)
    npz_a = synthetic_target(FOLD_L, seed=1)
    seq_a = synthetic_sequence(FOLD_L, seed=1)
    energy_a, rst_a, masks_a, w_cent = centroid_energy(npz_a, seq_a, dev)
    x0_a = start_torsions(7, FOLD_L, FOLD_DECOYS, dev)
    with torch.no_grad():
        start_a = energy_a(x0_a)
    log_a = []

    def request_a():
        res = fold_ensemble(npz_a, seq_a, torch.Generator().manual_seed(7),
                            n_decoys=FOLD_DECOYS, max_iter=FOLD_ITERS,
                            use_orient=True, device=dev, stage_log=log_a)
        with torch.no_grad():     # rescored through the dense entry
            fused = batched_energy_fused(
                res.torsions.reshape(FOLD_DECOYS, -1),
                tables_to(rst_a, dev), masks_to(masks_a, dev), w_cent)
        return res, fused

    (res_a, fused_a), req_a = run_fold_request("a", FOLD_L, FOLD_DECOYS,
                                               request_a, dev)
    print("stage_log a " + json.dumps(log_a), flush=True)
    check_fold("a", res_a.energy, start_a)
    check(all(0 < it <= max(FOLD_ITERS, 500) for lab, it, _ in log_a
              if lab != "idealize"),
          f"fold a: stage iterations out of range: {log_a}")
    labels = {lab for lab, _, _ in log_a}
    check({"cent", "relax1", "cart_r1", "relax2", "cart_refine",
           "idealize"} <= labels, f"fold a: stages missing: {labels}")
    check(req_a["spline_dense_launches"] == 4,
          "fold a: the dense rescoring did not launch 4 times")
    rescore = ((fused_a.double() - res_a.energy.double()).abs()
               / res_a.energy.double().abs()).max().item()
    print(f"fold a: dense-entry rescoring differs by {rescore} (relative)",
          flush=True)
    check(rescore <= RESCORE_TOL, f"fold a: rescoring differs by {rescore}")
    req_a["decoys"] = check_decoys("a", res_a, refined=True)
    req_a["pack"] = pack_phase(res_a, seq_a, dev)
    refine_band_phase(dev)

    # the relax and cartesian energies held to the plain spline path
    relax_a, r2_a, w_relax = relax_energies(npz_a, seq_a, dev)
    x_a = res_a.torsions.reshape(FOLD_DECOYS, -1)
    check_kernel_vs_plain("relax energy a", relax_a, x_a)
    t = res_a.torsions
    with torch.no_grad():
        atoms_a = build_backbone(t[:, 0], t[:, 1], t[:, 2])
    cart_a = cartmin._cart_efun(atoms_a, r2_a, w_relax, "compact")
    delta = torch.randn(FOLD_DECOYS, 15 * FOLD_L,
                        generator=torch.Generator().manual_seed(3))
    check_kernel_vs_plain("cartesian energy a", cart_a,
                          0.05 * delta.to(dev))

    # (b) slice 1's L=64 NMR pred_npz through the CLI, without relax
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

    def cli(out: str, *flags):
        return lambda: fold_cli.main(
            ["-NPZ", npz_b, "-FASTA", str(fasta), "-OUT",
             str(out_dir / out), "--n_decoys", str(CLI_DECOYS), "--seed",
             "5", "--device", str(dev), *flags])

    (paths, res_b), req_b = run_fold_request(
        "b", CLI_L, CLI_DECOYS, cli("t64.pdb", "--no-fastrelax"), dev)
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

    # (b') the same pred_npz through the CLI with no flags but I/O: relax,
    # cartesian refinement, full-atom PDBs
    log_c = []

    def request_c():
        # the CLI takes fold_ensemble from its module when it runs: wrap it
        # to keep the stage log
        import trx2dy_torch.physics.folder as folder

        def logged(*a, **kw):
            return fold_ensemble(*a, stage_log=log_c, **kw)
        folder.fold_ensemble = logged
        try:
            return cli("t64fa.pdb")()
        finally:
            folder.fold_ensemble = fold_ensemble

    (paths_c, res_c), req_c = run_fold_request("b'", CLI_L, CLI_DECOYS,
                                               request_c, dev)
    print("stage_log b' " + json.dumps(log_c), flush=True)
    check_fold("b'", res_c.energy, start_b)
    req_c["decoys"] = check_decoys("b'", res_c, refined=True)
    check(len(paths_c) == CLI_DECOYS, f"fold b': {len(paths_c)} PDBs")
    for k, path in enumerate(paths_c):
        with open(path) as f:
            names = {ln[12:16].strip() for ln in f if ln.startswith("ATOM")}
        check(len(names - {"N", "CA", "C", "O", "CB"}) > 0,
              f"{path}: no side-chain atoms")
        coords, seq = read_pdb_backbone(path)
        check(seq == seq_b, f"{path}: read back another sequence")
        for name in ("N", "CA", "C", "O"):
            got = res_c.atoms[name][k].cpu().numpy()
            check(float(np.abs(coords[name] - got).max()) < 1e-3,
                  f"{path}: {name} differs from the fold's atoms")

    req_r = repack_check(dev, npz, seq_b, start_b, res_c, req_c, log_c)

    profs = [profile_chunk(energy_a, x0_a, dev),
             profile_chunk(relax_a, x0_a, dev, label="relax"),
             profile_chunk(cart_a, torch.zeros_like(delta).to(dev), dev,
                           label="cartesian")]
    return [req_a, req_b, req_c, req_r], profs, res_a.atoms


def repack_check(dev, npz: dict, seq: str, start, res_off, req_off,
                 log_off) -> dict:
    """(b')'s fold with folder.REPACK_IN_LOOP on, from the same seed: one
    pair launch per spline-counted evaluation, energies below their
    starts, relax round 2 run as fa_stage, the first fa_stage energy and
    gradient held to the plain spline path; wall and packed clash energy
    against (b') with the switch off. The switch is restored."""
    from trx2dy_torch.physics import folder, sidechain

    first = {}
    fa_fun = folder._fa_weighted_fun

    def capture(*args):
        fun = fa_fun(*args)

        def recorded(xx):
            first.setdefault("fun", fun)
            first.setdefault("x", xx.detach().clone())
            return fun(xx)
        return recorded

    log = []
    folder.REPACK_IN_LOOP = True
    folder._fa_weighted_fun = capture
    try:
        res, req = run_fold_request(
            "b' repack", CLI_L, CLI_DECOYS,
            lambda: folder.fold_ensemble(
                npz, seq, torch.Generator().manual_seed(5),
                n_decoys=CLI_DECOYS, device=dev, stage_log=log), dev)
    finally:
        folder.REPACK_IN_LOOP = False
        folder._fa_weighted_fun = fa_fun
    check(not folder.REPACK_IN_LOOP, "repack: the switch was not restored")
    print("stage_log b' repack " + json.dumps(log), flush=True)
    check_fold("b' repack", res.energy, start)
    labels = [lab for lab, _, _ in log]
    check(labels.count("relax2_fa") == 4 * folder.RELAX_REPEATS
          and "relax2" not in labels,
          f"repack: relax round 2 did not run as fa_stage: {labels}")
    req["fa_stage_first_eval"] = check_kernel_vs_plain(
        "fa_stage energy b'", first["fun"], first["x"])
    pin = sidechain.pack_input(seq, dev)

    def packed_clash(r):
        xyz, _, _ = sidechain.pack_ensemble(r.torsions, seq,
                                            backbone=r.atoms, device=dev)
        with torch.no_grad():
            return sidechain._clash_energy(xyz, pin).double().cpu()
    on, off = packed_clash(res), packed_clash(res_off)
    out = {"wall_s_on": req["wall_s"], "wall_s_off": req_off["wall_s"],
           "stages_s_on": sum(t for _, _, t in log),
           "stages_s_off": sum(t for _, _, t in log_off),
           "fa_stages_s": sum(t for lab, _, t in log if lab == "relax2_fa"),
           "relax2_stages_s_off": sum(t for lab, _, t in log_off
                                      if lab == "relax2"),
           "energy_evals_on": req["energy_evals"],
           "energy_evals_off": req_off["energy_evals"],
           "restraint_free_evals_on": req["restraint_free_evals"],
           "energy_median_on": res.energy.median().item(),
           "energy_median_off": res_off.energy.median().item(),
           "packed_clash_median_on": on.median().item(),
           "packed_clash_median_off": off.median().item(),
           "packed_clash_mean_on": on.mean().item(),
           "packed_clash_mean_off": off.mean().item()}
    print("repack " + json.dumps(out), flush=True)
    req["repack"] = out
    return req


def dampened_chain_stage(dev, save: Path, name: str, seq: str,
                         cand: int):
    """A chain step's first-stage tables as the driver builds them: both
    models' predicted histograms, eight chains each, dampened by written
    initial decoys (conf_1_k / conf_2_k, k = 1..8, read back), compiled
    for 2 x 8 chains x `cand` candidate lanes. Returns (the stage, the
    chains before and after dampening)."""
    from trx2dy_torch.dynamics import driver
    from trx2dy_torch.dynamics.loop import histograms_from_npz
    from trx2dy_torch.geometry.transforms import virtual_cb
    from trx2dy_torch.io.pdbio import read_pdb_backbone
    from trx2dy_torch.physics.compact import _bucket, union_stage
    from trx2dy_torch.physics.folder import GROWTH_HEADROOM
    from trx2dy_torch.physics.tablegen import union_compiler
    K = 8
    hists = []
    for tag in ("NMR", "Xray"):
        with np.load(save / name / "pred_npz" / f"{name}_{tag}.npz") as f:
            hists += [histograms_from_npz(dict(f), dev)] * K
    chains = driver._stack_hists(hists)
    atoms = {k: [] for k in ("N", "CA", "C")}
    for conf in (1, 2):
        for k in range(1, K + 1):
            coords, _ = read_pdb_backbone(
                str(save / name / "pred_pdb" / f"conf_{conf}_{k}.pdb"))
            for a in atoms:
                atoms[a].append(coords[a])
    n, ca, c = (torch.as_tensor(np.stack(atoms[a]), dtype=torch.float32,
                                device=dev) for a in ("N", "CA", "C"))
    new, _ = driver._chain_update_batch(
        chains, n, ca, c, virtual_cb(n, ca, c),
        torch.ones((2 * K,), dtype=torch.bool, device=dev), 1.0, True)
    pool = {f: getattr(new, f) for f in GRIDS}
    comp = union_compiler(seq, device=dev)
    counts = comp.count(pool)[1].tolist()
    P = tuple(_bucket(int(np.ceil(c * GROWTH_HEADROOM))) for c in counts)
    ur, stage_acts, _, _ = comp.compile(
        pool, np.repeat(np.arange(2 * K), cand), P)
    return union_stage(ur, stage_acts[0]), chains, new


def run_single_phase(dev, work: Path, a3m: Path, model_dir: Path,
                     seq: str) -> dict:
    """Phase 6: run_single through the run_inference CLI at its defaults
    but --Nmax, with every launch counter at 0 just before and read just
    after; then the chain-step checks on the card."""
    from trx2dy_torch.cli import run_inference
    from trx2dy_torch.dynamics.driver import DynamicsConfig
    from trx2dy_torch.ops.spline_energy import (
        spline_energy_dense, spline_energy_lanes, spline_energy_pairs,
    )
    from trx2dy_torch.physics import energy
    from trx2dy_torch.physics.folder import _bucket_size
    from trx2dy_torch.physics.minimize import STATS

    name = "run64"
    fasta = work / f"{name}.fasta"
    fasta.write_text(f">{name}\n{seq}\n")
    save = work / "run_single"
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    spline_energy_pairs.launches = spline_energy_dense.launches = 0
    spline_energy_lanes.launches = 0
    STATS.reset()
    t0 = time.perf_counter()
    run_inference.main(["--fasta", str(fasta), "--msa", str(a3m),
                        "--name", name, "--model_dir", str(model_dir),
                        "--save_dir", str(save), "--Nmax", str(RUN_NMAX)])
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    out = {"L": len(seq), "Nmax": RUN_NMAX, "wall_s": wall,
           "energy_evals": STATS.evals,
           "restraint_free_evals": STATS.free_evals,
           "host_syncs": STATS.syncs,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "spline_lanes_launches": spline_energy_lanes.launches,
           "spline_pair_launches": spline_energy_pairs.launches,
           "spline_dense_launches": spline_energy_dense.launches}
    check(STATS.evals > 0 and spline_energy_lanes.launches == STATS.evals,
          f"run_single: {spline_energy_lanes.launches} lanes launches for "
          f"{STATS.evals} energy evaluations, expected 1 per evaluation")
    check(spline_energy_pairs.launches == 0
          and spline_energy_dense.launches == 0,
          "run_single: the pair or dense entry launched on the chain path")

    root = save / name
    with open(root / "traces.jsonl") as f:
        rows = [json.loads(ln) for ln in f]
    phases = [r for r in rows if r["kind"] == "phase"]
    chain_rows = [r for r in rows if r["kind"] == "chain"]
    steps = [r for r in phases if isinstance(r["step"], int)]
    check(phases and phases[0]["step"] == "initial" and steps
          and phases[-1]["step"] == "io_drain",
          f"run_single: trace phase rows {[r['step'] for r in phases]}")
    check(not (root / "tmp_npz").exists(), "run_single: tmp_npz remains")
    cfg = DynamicsConfig()
    pdbs = sorted(os.listdir(root / "pred_pdb"))
    for conf, tag in ((1, "NMR"), (2, "Xray")):
        made = sum(r.get("model") == tag for r in chain_rows)
        have = sum(p.startswith(f"conf_{conf}_") for p in pdbs)
        check(1 <= made <= RUN_NMAX and have == cfg.init_num + made,
              f"run_single: {have} conf_{conf} PDBs for {made} {tag} "
              f"chain decoys")
    check(all(p.startswith("conf_") for p in pdbs),
          f"run_single: unrenamed PDBs {pdbs}")
    for p in pdbs:
        with open(root / "pred_pdb" / p) as f:
            atoms = {ln[12:16].strip() for ln in f if ln.startswith("ATOM")}
        check(len(atoms - {"N", "CA", "C", "O", "CB"}) > 0,
              f"run_single: {p} has no side-chain atoms")
    decoys = len(pdbs)
    fold_s = sum(r["t_fold"] for r in phases if "t_fold" in r)
    out.update({
        "decoys": decoys, "decoys_per_min": 60.0 * decoys / wall,
        "ms_per_eval": 1e3 * wall / max(STATS.evals, 1),
        "fold_ms_per_eval": 1e3 * fold_s / max(STATS.evals, 1),
        "phases": [{k: v for k, v in r.items() if k != "kind"}
                   for r in phases]})
    print("run_single " + json.dumps(out), flush=True)

    # a chain step's tables on the card: kernel against the plain path
    M, K = 2, cfg.n_chains
    n_init = int(np.ceil(cfg.init_num * (1.0 + cfg.oversample)))
    bucket = _bucket_size(max(M * n_init, M * K * cfg.chain_candidates))
    stage, before, after = dampened_chain_stage(dev, save, name, seq,
                                                bucket // (M * K))
    for f in ("dist", "omega", "theta", "phi"):
        old, new = getattr(before, f), getattr(after, f)
        masked = old.amax(-1) < 0.5
        err = (new.sum(-1) - 1.0).abs()[masked].max().item() \
            if bool(masked.any()) else 0.0
        check(err <= DAMPEN_NORM_TOL,
              f"run_single: dampened {f} bins sum off 1 by {err}")
    w = torch.as_tensor(energy.weights_to_vec(energy.SCOREFXN_CENT),
                        device=dev)
    fun = lambda x: energy.batched_energy_weighted_union(x, stage, w)
    x0 = start_torsions(11, len(seq), bucket, dev)
    out["chain_step_first_eval"] = check_kernel_vs_plain(
        "chain step energy", fun, x0)
    e_k, g_k = value_and_grad(fun, x0)
    e_r, g_r = value_and_grad(fun, x0)
    check(torch.equal(e_k, e_r) and torch.equal(g_k, g_r),
          "chain step: a repeated energy evaluation is not bit-identical")
    out["union_profile"] = profile_chunk(fun, x0, dev, label="union")
    return out


def check_against_native(label: str, tm, rmsd, tm_nat, rmsd_nat) -> dict:
    """Hold the device engine's TM and RMSD (numpy) to the native engine's:
    never lower by more than NATIVE_TM_TOL, within it where TM >=
    NATIVE_TM_FROM, RMSD within RMSD_TOL relative; returns the largest
    differences."""
    diff = tm - tm_nat
    high = tm_nat >= NATIVE_TM_FROM
    out = {"pairs": int(tm.size), "pairs_tm_ge_0.5": int(high.sum()),
           "tm_max_abs_diff": float(np.abs(diff).max()),
           "tm_max_abs_diff_ge_0.5": float(np.abs(diff[high]).max())
           if high.any() else None,
           "tm_min_diff": float(diff.min()),
           "rmsd_max_rel_diff": float((np.abs(rmsd - rmsd_nat)
                                       / np.maximum(1.0, rmsd_nat)).max())}
    print(f"{label} device vs native engine " + json.dumps(out), flush=True)
    check(out["tm_min_diff"] >= -NATIVE_TM_TOL,
          f"{label}: device TM below the native one by {-out['tm_min_diff']}")
    check(not high.any() or out["tm_max_abs_diff_ge_0.5"] <= NATIVE_TM_TOL,
          f"{label}: TM >= {NATIVE_TM_FROM} differs by "
          f"{out['tm_max_abs_diff_ge_0.5']}")
    check(out["rmsd_max_rel_diff"] <= RMSD_TOL,
          f"{label}: RMSD differs by {out['rmsd_max_rel_diff']} (relative)")
    return out


def timed(dev, fn):
    """(fn(), wall seconds) with the device synchronised at both ends."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def analysis_phase(dev, work: Path, atoms_a: dict) -> dict:
    """Phase 7, first half: fold (a)'s quality, the all-vs-all matrices,
    the cluster and evaluate CLIs on phase 6's decoys."""
    from trx2dy_torch import native
    from trx2dy_torch.analysis.tmscore import tm_score_batch
    from trx2dy_torch.cli import cluster as cluster_cli
    from trx2dy_torch.cli import evaluate as evaluate_cli

    check(native.available(), "the native library did not build")
    out = {}
    # fold (a) against the walk that gave its CB-CB distance histograms
    walk = compact_walk(FOLD_L, seed=1)
    cb = atoms_a["CB"]
    r, wall = timed(dev, lambda: tm_score_batch(cb, walk, device=dev))
    check(r.tm.device.type == dev.type and r.tm.shape == (FOLD_DECOYS,),
          f"tm_score_batch: {r.tm.shape} on {r.tm.device}")
    tm, rmsd = r.tm.cpu().numpy(), r.rmsd.cpu().numpy()
    cb_np = cb.cpu().numpy()
    t0 = time.perf_counter()
    nat = np.array([native.tmscore(c, walk) for c in cb_np])
    t_nat = time.perf_counter() - t0
    out["fold_a_quality"] = {
        "decoys": FOLD_DECOYS, "L": FOLD_L, "atoms": "CB",
        "tm_median": float(np.median(tm)), "tm_max": float(tm.max()),
        "tm_min": float(tm.min()), "rmsd_median": float(np.median(rmsd)),
        "gdt_ts_median": float(r.gdt_ts.median()),
        "device_s": wall, "native_s": t_nat,
        **check_against_native("fold a quality", tm, rmsd, nat[:, 0],
                               nat[:, 1])}
    print("quality a " + json.dumps(out["fold_a_quality"]), flush=True)

    # all-vs-all over the decoys' CA traces: device engine and native
    ca = atoms_a["CA"]
    i, j = np.triu_indices(FOLD_DECOYS, k=1)
    ii, jj = (torch.as_tensor(a, device=ca.device) for a in (i, j))
    r, t_dev = timed(dev, lambda: tm_score_batch(ca[ii], ca[jj], device=dev))
    t0 = time.perf_counter()
    tm_nat, rmsd_nat = native.tmscore_matrix(ca.cpu().numpy())
    t_nat = time.perf_counter() - t0
    out["all_vs_all"] = {
        "decoys": FOLD_DECOYS, "device_s": t_dev, "native_s": t_nat,
        **check_against_native("all-vs-all", r.tm.cpu().numpy(),
                               r.rmsd.cpu().numpy(), tm_nat[i, j],
                               rmsd_nat[i, j])}
    print("all_vs_all " + json.dumps(out["all_vs_all"]), flush=True)

    # the cluster CLI on phase 6's conf_* PDBs, each mode
    pdb_dir = work / "run_single" / "run64" / "pred_pdb"
    confs = sorted(p.name for p in pdb_dir.glob("conf_*.pdb"))
    try:
        import sklearn  # noqa: F401
        kmeans = "sklearn"
    except ImportError:
        kmeans = "numpy (sklearn absent)"
    out["cluster"] = {"decoys": len(confs), "kmeans": kmeans}
    for mode in ("glocon", "tmscore", "rmsd"):
        dest = work / "cluster" / mode
        res, wall = timed(dev, lambda: cluster_cli.main(
            ["-d", str(pdb_dir), "-m", mode, "-o", str(dest),
             "--n_clusters", str(CLUSTERS), "--device", str(dev)]))
        # numpy k-means may leave a cluster empty; sklearn's does not
        check(res != "no_cluster" and 1 <= len(res) <= CLUSTERS
              and set(res) <= set(range(CLUSTERS))
              and sorted(f for fs in res.values() for f in fs) == confs,
              f"cluster {mode}: {res}")
        copied = sorted(p.name for p in dest.iterdir())
        want = sorted(f for fs in res.values() for f in fs[:5])
        check(copied == want and all(
            (dest / f).read_bytes() == (pdb_dir / f).read_bytes()
            for f in copied), f"cluster {mode}: copied {copied}")
        out["cluster"][mode] = {"wall_s": wall, "sizes": sorted(
            len(fs) for fs in res.values()), "copied": len(copied)}
    print("cluster " + json.dumps(out["cluster"]), flush=True)

    # the evaluate CLI: two of (b')'s full-atom decoys as natives
    nat_dir = work / "natives"
    nat_dir.mkdir(exist_ok=True)
    for k in (0, 1):
        shutil.copy(work / "fold" / f"t64fa_{k}.pdb", nat_dir)
    summary = work / "eval" / "summary.txt"
    stats, wall = timed(dev, lambda: evaluate_cli.main(
        ["-n", str(nat_dir), "-p", str(pdb_dir), "-o", str(summary),
         "--device", str(dev)]))
    lines = summary.read_text().splitlines()
    stat_names = ("Mean RMSD:", "Mean TM-score:", "Min RMSD:",
                  "Max TM-score:")
    check(len(lines) == 6 and all(
        lines[k].startswith(f"t64fa_{k} best_RMSD: ")
        and " best_TM_score: " in lines[k] for k in (0, 1))
        and all(ln.startswith(n) for ln, n in zip(lines[2:], stat_names))
        and all(v is not None and np.isfinite(v) for v in stats),
        f"evaluate: summary.txt {lines}")
    out["evaluate"] = {"natives": 2, "predictions": len(confs),
                       "wall_s": wall, "summary": lines}
    print("evaluate " + json.dumps(out["evaluate"]), flush=True)
    return out


def chain_fold_phase(dev, npz_paths: dict, seq: str) -> dict:
    """Phase 7, second half: fold_chains at the sampler's width with every
    launch counter at 0 just before and read just after, then its checks
    on the card."""
    from trx2dy_torch.ops.spline_energy import (
        spline_energy_dense, spline_energy_lanes, spline_energy_pairs,
    )
    from trx2dy_torch.physics import energy, folder
    from trx2dy_torch.physics.minimize import STATS

    npzs = []
    for tag in ("NMR", "Xray"):
        with np.load(npz_paths[tag]) as f:
            npzs += [dict(f)] * CHAIN_NPZ_CHAINS
    K = len(npzs)
    seen = {}
    protocol = folder._protocol_staged

    def spy(x0, stages, *a, **kw):
        seen["x0"], seen["stages"] = x0, stages
        seen["x"], seen["f"] = protocol(x0, stages, *a, **kw)
        return seen["x"], seen["f"]

    log = []
    folder._protocol_staged = spy
    try:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        spline_energy_pairs.launches = spline_energy_dense.launches = 0
        spline_energy_lanes.launches = 0
        STATS.reset()
        res, wall = timed(dev, lambda: folder.fold_chains(
            npzs, seq, torch.Generator().manual_seed(13), mode=2,
            max_iter=CHAIN_FOLD_ITERS, candidates=CHAIN_CANDIDATES,
            lane_bucket=CHAIN_LANES, device=dev, stage_log=log))
    finally:
        folder._protocol_staged = protocol
    L = len(seq)
    out = {"L": L, "chains": K, "candidates": CHAIN_CANDIDATES,
           "lanes": CHAIN_LANES, "max_iter": CHAIN_FOLD_ITERS,
           "wall_s": wall, "energy_evals": STATS.evals,
           "ms_per_eval": 1e3 * wall / max(STATS.evals, 1),
           "restraint_free_evals": STATS.free_evals,
           "host_syncs": STATS.syncs,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "spline_lanes_launches": spline_energy_lanes.launches,
           "spline_pair_launches": spline_energy_pairs.launches,
           "spline_dense_launches": spline_energy_dense.launches,
           "table_rows": seen["stages"][0].ur.dist.tab.shape[1],
           "pairs": list(seen["stages"][0].splines.sizes)}
    print("chain_fold " + json.dumps(out), flush=True)
    print("stage_log chain_fold " + json.dumps(log), flush=True)
    check(STATS.evals > 0 and spline_energy_lanes.launches == STATS.evals,
          f"chain fold: {spline_energy_lanes.launches} lanes launches for "
          f"{STATS.evals} energy evaluations, expected 1 per evaluation")
    check(spline_energy_pairs.launches == 0
          and spline_energy_dense.launches == 0,
          "chain fold: the pair or dense entry launched")
    check(res.torsions.shape == (K, 3, L) and res.atoms["CA"].shape
          == (K, L, 3) and out["table_rows"] == 2,
          f"chain fold: torsions {tuple(res.torsions.shape)}, "
          f"{out['table_rows']} table rows")
    check({"cent", "relax1", "cart_r1", "relax2", "cart_refine"}
          <= {lab for lab, _, _ in log}, f"chain fold: stages {log}")
    f = seen["f"].cpu()
    pick = torch.arange(K) * CHAIN_CANDIDATES + torch.argmin(
        f[:K * CHAIN_CANDIDATES].reshape(K, CHAIN_CANDIDATES), dim=1)
    check(torch.equal(res.energy.cpu(), f[pick]),
          "chain fold: a chain did not keep its lowest-energy candidate")
    w = torch.as_tensor(energy.weights_to_vec(energy.SCOREFXN_CENT),
                        device=dev)
    first, last = seen["stages"][0], seen["stages"][-1]
    with torch.no_grad():
        start = energy.batched_energy_weighted_lanes(seen["x0"], last, w)
    check_fold("chain fold", res.energy, start[pick.to(dev)])

    def fun(x):
        return energy.batched_energy_weighted_lanes(x, first, w)
    out["first_eval"] = check_kernel_vs_plain("chain fold energy", fun,
                                              seen["x0"])
    e_k, g_k = value_and_grad(fun, seen["x0"])
    e_r, g_r = value_and_grad(fun, seen["x0"])
    check(torch.equal(e_k, e_r) and torch.equal(g_k, g_r),
          "chain fold: a repeated energy evaluation is not bit-identical")
    return out


# --------------------------------------------------------------------------
# phase 8: the e2e static predictor
# --------------------------------------------------------------------------

def write_e2e_models(model_dir: Path, esm_sizes=None, fold_sizes=None):
    """Seeded random weights of ESM-MSA-1b and Folding (published sizes
    unless given), written once in the published checkpoints' formats:
    model_1.pth.tar, a state_dict, and esm_msa1_t12_100M_UR50S.pt, a
    fairseq checkpoint (its keys under 'encoder.sentence_encoder.' or
    'encoder.', row and column exchanged, and its training args as an
    argparse.Namespace). Compressed npz files of random
    weights took 32.6 s to write and 5.8 s a run to read on the card's
    host (PERF.md)."""
    from trx2dy_torch.models.convert import (
        init_esm_state_dict, init_folding_state_dict,
    )
    model_dir.mkdir(parents=True, exist_ok=True)
    swap = {"row": "column", "column": "row"}

    def fairseq(key):
        for a, b in swap.items():
            if a in key:
                key = key.replace(a, b)
                break
        return ("encoder.sentence_encoder." if key.startswith("layers.")
                else "encoder.") + key
    esm = init_esm_state_dict(21, **(esm_sizes or {}))
    torch.save({"model": {fairseq(k): torch.from_numpy(v)
                          for k, v in esm.items()},
                "args": argparse.Namespace(arch="msa_transformer")},
               model_dir / "esm_msa1_t12_100M_UR50S.pt")
    fold = init_folding_state_dict(22, **(fold_sizes or {}))
    torch.save({k: torch.from_numpy(v) for k, v in fold.items()},
               model_dir / "model_1.pth.tar")


def check_e2e_files(out_dir: Path, L: int, nrows: int) -> dict:
    """The CLI's file contract; returns the saved arrays."""
    from trx2dy_torch.io.a3m import parse_a3m
    filt = out_dir / f"filter{nrows}.a3m"
    check(filt.is_file(), f"e2e: {filt.name} missing")
    rows = parse_a3m(str(filt), limit=10 ** 6)
    check(rows.shape[1] == L and rows.shape[0] >= 2,
          f"e2e: {filt.name} holds {rows.shape}")
    bins = {"dist": 37, "omega": 25, "theta": 25, "phi": 13}
    with np.load(out_dir / "model_1_results.npz") as f:
        check(set(f.files) == {"plddt", *bins}, f"e2e: npz keys {f.files}")
        out = {k: f[k] for k in f.files}
    for key, n in bins.items():
        p = out[key]
        check(p.shape == (L, L, n) and p.dtype == np.float32,
              f"e2e: {key} {p.shape} {p.dtype}")
        check(bool(np.isfinite(p).all()), f"e2e: {key} not finite")
        err = float(np.abs(p.sum(-1) - 1).max())
        check(err <= E2E_NORM_TOL, f"e2e: {key} sums off 1 by {err}")
    plddt = out["plddt"]
    check(plddt.shape == (L,) and bool(np.isfinite(plddt).all())
          and bool(((plddt >= 0) & (plddt <= 1)).all()),
          f"e2e: pLDDT {plddt.shape} outside [0, 1] or not finite")
    with open(out_dir / "model_1.pdb") as f:
        atoms = [ln for ln in f if ln.startswith("ATOM")]
    check(len({ln[22:26] for ln in atoms}) == L,
          f"e2e: the PDB has {len({ln[22:26] for ln in atoms})} residues")
    check(abs(float(atoms[0][60:66]) - 100 * plddt[0]) < 0.01,
          "e2e: the PDB's B-factors are not the pLDDT")
    lines = (out_dir / "plddt.csv").read_text().splitlines()
    check(lines[0] == "Residue_Index,pLDDT" and len(lines) == L + 1
          and lines[1] == f"1,{float(plddt[0])}",
          f"e2e: plddt.csv starts {lines[:2]}")
    return out


def saturation(a: dict, b: dict) -> dict:
    """Per map: the median over (i, j) of each distribution's largest
    probability in a and in b, and the share of (i, j) whose most probable
    bin differs between them."""
    out = {}
    for key in GRIDS:
        out[key] = {"median_max_p": [float(np.median(x[key].max(-1)))
                                     for x in (a, b)],
                    "mode_flips": float(np.mean(a[key].argmax(-1)
                                                != b[key].argmax(-1)))}
    return out


def trunk_device_split(call) -> dict:
    """One trunk forward, call(), traced by torch.profiler (warm): the
    device time of the attention kernel and of every kernel, in ms."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
    events = prof.key_averages()
    total = sum(event_device_us(e) for e in events) / 1e3
    attn = sum(event_device_us(e) for e in events
               if "tri_attn_fwd_kernel" in e.key) / 1e3
    return {"tri_attn_device_ms": attn, "all_kernels_device_ms": total,
            "tri_attn_share_of_trunk_device": attn / total if total else None}


def e2e_phase(dev, work: Path, L=E2E_L, rows=E2E_ROWS, nrows=E2E_NROWS,
              recycles=E2E_RECYCLES, esm_sizes=None, fold_sizes=None) -> dict:
    """Phase 8: the e2e predictor's CLI at the default bf16 and in float32
    (each E2E_LAUNCHES attention launches, counted from 0 per run), both
    recomputed on the plain attention; the kernel held against float64 on
    the inputs the bf16 run gave it; the maps' saturation; wall split,
    memory, and the kernel's share of a traced trunk forward."""
    import trx2dy_torch.models.predictor2d as p2d
    from trx2dy_torch.cli import predict
    from trx2dy_torch.ops.triangle_attention import (
        tri_attn_core, tri_attn_core_plain,
    )

    mdir = work / "e2e_models"
    t0 = time.perf_counter()
    write_e2e_models(mdir, esm_sizes, fold_sizes)
    t_weights = time.perf_counter() - t0
    a3m = work / f"e2e{L}.a3m"
    write_synthetic_a3m(a3m, L, rows, seed=2 * L + 1)
    depth = (fold_sizes or {}).get("depth", DEPTH)
    expected = 2 * depth * (1 + recycles)

    def run(tag, *flags, core=tri_attn_core):
        out_dir = work / f"e2e_{tag}"
        timings = []
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        tri_attn_core.launches = 0
        kernel_core, p2d.tri_attn_core = p2d.tri_attn_core, core
        try:
            t0 = time.perf_counter()
            res = predict.main(["-i", str(a3m), "-o", str(out_dir), "-mdir",
                                str(mdir), "-nrows", str(nrows), "-nrec",
                                str(recycles), "--device", str(dev), *flags],
                               timings=timings)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        finally:
            p2d.tri_attn_core = kernel_core
        launched = tri_attn_core.launches
        req = {"run": tag, "L": L, "rows": rows, "nrows": nrows,
               "recycles": recycles, "wall_s": wall,
               "stages_s": {k: v for k, v in timings},
               "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               "tri_attn_launches": launched}
        print("e2e " + json.dumps(req), flush=True)
        arrays = check_e2e_files(out_dir, L, nrows)
        arrays["ca"] = res["atom14"][:, 1].double().cpu().numpy()
        check(bool(np.isfinite(res["atom14"].double().cpu().numpy()).all()),
              f"e2e {tag}: non-finite atom14")
        return arrays, req

    # the bf16 run keeps the first and the last inputs its attention
    # kernel was given; the float32 run, its first trunk call
    seen = {}

    def keep_inputs(q, k, v, bias, wise):
        seen.setdefault("first", (q, k, v, bias, wise))
        seen["last"] = (q, k, v, bias, wise)
        return tri_attn_core(q, k, v, bias, wise)

    bf16, req_bf16 = run("bf16", core=keep_inputs)
    trunk_forward = p2d.Predictor2D.forward

    def keep_trunk_call(self, *args, **kwargs):
        seen.setdefault("trunk", (self, args, kwargs))
        return trunk_forward(self, *args, **kwargs)

    p2d.Predictor2D.forward = keep_trunk_call
    try:
        f32, req_f32 = run("f32", "--no-bf16")
    finally:
        p2d.Predictor2D.forward = trunk_forward
    for req in (req_bf16, req_f32):
        check(req["tri_attn_launches"] == expected,
              f"e2e {req['run']}: {req['tri_attn_launches']} attention "
              f"launches, expected {expected}")
    plain, req_plain = run("plain", "--no-bf16", core=tri_attn_core_plain)
    bf16_plain, req_bf16_plain = run("bf16_plain", core=tri_attn_core_plain)
    for req in (req_plain, req_bf16_plain):
        check(req["tri_attn_launches"] == 0,
              f"e2e {req['run']}: the kernel launched on the plain path")

    # the kernel on the bf16 run's own inputs (float32 by then), against
    # float64, as the kernel phase holds it on random inputs
    bf16_inputs_err = {}
    for which in ("first", "last"):
        q, k, v, bias, wise = seen[which]
        check(all(t.dtype == torch.float32 for t in (q, k, v, bias)),
              f"e2e bf16: the attention kernel was given "
              f"{[t.dtype for t in (q, k, v, bias)]}")
        ref = tri_attn_core_plain(q.double(), k.double(), v.double(),
                                  bias.double(), wise)
        err = (tri_attn_core(q, k, v, bias, wise).double() - ref) \
            .abs().max().item()
        scale = max(1.0, v.abs().max().item())
        bf16_inputs_err[which] = err
        check(err <= TRI_ATTN_TOL * scale,
              f"e2e bf16: the kernel is {err} from float64 on the run's "
              f"{which} inputs (max |v| {scale})")
    del seen["first"], seen["last"], q, k, v, bias, ref

    def diff(a, b):
        return {"probabilities": max(float(np.abs(a[k] - b[k]).max())
                                     for k in GRIDS),
                "plddt": float(np.abs(a["plddt"] - b["plddt"]).max()),
                "ca": float(np.abs(a["ca"] - b["ca"]).max())}
    module, args, kwargs = seen.pop("trunk")
    trunks = [v for k, v in req_f32["stages_s"].items()
              if k.startswith("trunk_")]
    split = trunk_device_split(lambda: module(*args, **kwargs))
    del module, args, kwargs
    split["trunk_wall_ms_f32"] = 1e3 * sum(trunks) / len(trunks)
    out = {"write_weights_s": t_weights,
           "f32_vs_plain": diff(f32, plain),
           "bf16_vs_plain": diff(bf16, bf16_plain),
           "bf16_vs_f32": diff(bf16, f32),
           "bf16_kernel_vs_f64_on_run_inputs": bf16_inputs_err,
           "saturation_bf16_vs_f32": saturation(bf16, f32),
           "saturation_bf16_vs_bf16_plain": saturation(bf16, bf16_plain),
           "plddt_mean": {"bf16": float(bf16["plddt"].mean()),
                          "f32": float(f32["plddt"].mean())},
           "trunk_f32": split}
    print("e2e check " + json.dumps(out), flush=True)
    d = out["f32_vs_plain"]
    check(d["probabilities"] <= PLAIN_PATH_TOL,
          f"e2e: kernel path differs from plain path by "
          f"{d['probabilities']} in probability")
    check(d["plddt"] <= E2E_PLDDT_TOL,
          f"e2e: pLDDT differs from the plain path by {d['plddt']}")
    check(d["ca"] <= E2E_CA_TOL,
          f"e2e: CA differs from the plain path by {d['ca']} A")
    return {"runs": [req_bf16, req_f32, req_plain, req_bf16_plain], **out,
            "tri_attn_launches": req_bf16["tri_attn_launches"]
            + req_f32["tri_attn_launches"]}


def kernel_summary(kernel_rows, spline_rows, launches: int, folds,
                   run_single=None, chain_fold=None) -> list:
    """The `kernels` line: every kernel with its launches on the main path,
    its error, its times and its bound."""
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
        "wrapper_ms": mean("kernel_ms"),
        "kernel_ms_ijh_bias": mean("kernel_ms_ijh_bias"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": at_max[0]["bound_ms"],
        "bound_by": at_max[0]["bound_by"],
        "bound_ms_3xtf32": at_max[0]["bound_ms_3xtf32"],
        "library_ms": mean("library_ms"),
        "shape": f"L={max(KERNEL_LENGTHS)}, H={HEADS}, D={HEAD_DIM}, f32; "
                 "launches: the geometry requests' and the e2e predictor's "
                 f"bf16 and f32 runs ({E2E_LAUNCHES} each; its bf16 path "
                 "upcasts q, k, v and the bias to this f32 kernel); "
                 "times are the mean of the row- and column-wise calls, "
                 "taken through the wrapper by CUDA events (one launch of "
                 "milliseconds, so kernel and wrapper time are one), "
                 "with the trunk's head-major bias (kernel_ms_ijh_bias: an "
                 "(L, L, H) bias); bound_ms counts f32 operations at the "
                 "f32 rate, bound_ms_3xtf32 the kernel's 3 TF32 products",
    }]
    B, L = SPLINE_SHAPES[0]
    dense = [r for r in spline_rows if r["entry"] == "dense"]
    main_dense = [r for r in dense if r["B"] == B and r["L"] == L]
    total = lambda k: sum(r[k] for r in main_dense)
    pairs = next(r for r in spline_rows if r["entry"] == "pairs")
    lanes_rows = [r for r in spline_rows if r["entry"] == "lanes"]
    lanes = next(r for r in lanes_rows if r["L"] == L and r["map"] == "chain")
    common = {"route": "cuda", "source": "trx2dy_torch/csrc/spline_energy.cu",
              "replaces": "trx2dy/ops/spline_energy.py:27",
              "library_ms": None,
              "library": "none: no single PyTorch call evaluates a masked "
                         "natural-cubic spline with its derivative"}
    kernels.append({
        "name": "spline_energy_dense", **common,
        "launches": sum(f["spline_dense_launches"] for f in folds),
        "max_abs_err": max(r["max_abs_err"] for r in dense),
        "ms": total("kernel_ms"),
        "kernel_ms": total("kernel_ms"),
        "wrapper_ms": total("wrapper_ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                   for r in main_dense) else "operations",
        "shape": f"B={B}, L={L}, f32; times and bound are the sum of one "
                 "call per knot grid (dist, omega, theta, phi)",
    })
    kernels.append({
        "name": "spline_energy_pairs", **common,
        "launches": sum(f["spline_pair_launches"] for f in folds),
        "max_abs_err": pairs["max_abs_err"],
        "ms": pairs["kernel_ms"],
        "kernel_ms": pairs["kernel_ms"],
        "wrapper_ms": pairs["wrapper_ms"],
        "plain_ms": pairs["plain_ms"],
        "bound_ms": pairs["bound_ms"],
        "bound_by": pairs["bound_by"],
        "shape": f"B={B}, P=" + "/".join(str(P) for P in pairs["P"])
                 + ", f32; one launch for the four knot grids (dist, omega, "
                   "theta, phi: one energy evaluation)",
    })
    kernels.append({
        "name": "spline_energy_lanes", **common,
        "replaces": "trx2dy/ops/spline_energy.py:27 (the sampler's "
                    "per-lane tables, trx2dy/physics/spline.py:289)",
        "launches": sum((r or {}).get("spline_lanes_launches", 0)
                        for r in (run_single, chain_fold)),
        "max_abs_err": max(r["max_abs_err"] for r in lanes_rows),
        "ms": lanes["kernel_ms"],
        "kernel_ms": lanes["kernel_ms"],
        "wrapper_ms": lanes["wrapper_ms"],
        "plain_ms": lanes["plain_ms"],
        "bound_ms": lanes["bound_ms"],
        "bound_by": lanes["bound_by"],
        "bound_ms_per_query": lanes["bound_ms_per_query"],
        "per_map": [{k: r[k] for k in (
            "L", "map", "rows", "table_mb", "kernel_ms", "wrapper_ms",
            "plain_ms", "bound_ms", "bound_ms_per_query", "max_abs_err")}
            for r in lanes_rows],
        "shape": f"C={lanes['C']}, L={L}, P="
                 + "/".join(str(P) for P in lanes["P"])
                 + ", f32 interval tables (P, U', K-1, 4) of the chain "
                   "step's map (16 rows x 2 candidates); one launch for the "
                   "four knot grids (one energy evaluation of the sampler); "
                   "bound_ms counts 16 B per distinct (pair, row, interval) "
                   "an active query touches, bound_ms_per_query 16 B per "
                   "active query; per_map: every map (cyclic: 8 rows in turn, "
                   "initial: 2 rows x 13 lanes padded, chain) at L=150 and "
                   "phase 6's L=64",
    })
    return kernels


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
        folds, prof, atoms_a = fold_phase(dev, WORK, outputs[CLI_L]["NMR"],
                                          query)
        print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)
        run = run_single_phase(dev, WORK, WORK / f"t{CLI_L}.a3m",
                               WORK / "models", query)
        print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)
        analysis_phase(dev, WORK, atoms_a)
        print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)
        chain = chain_fold_phase(dev, outputs[CLI_L], query)
        print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)
        e2e = e2e_phase(dev, WORK)
        print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    kernels = kernel_summary(kernel_rows, spline_rows,
                             launches + e2e["tri_attn_launches"], folds, run,
                             chain)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

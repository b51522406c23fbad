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
     shapes the main path gives it, row- and column-wise, within the stated
     tolerance of a float64 computation; kernel, plain and library times
     beside the bound the card's data sheet gives;
  4. the main path: the geometry stage (a3m -> features -> Predictor2D at
     full width, depth 12, random seeded weights -> pred_npz for both
     models) answers three requests at L = 64, 256, 400 with 1000 MSA rows.
     Launch counts are reset just before and read just after; outputs are
     checked for shape, finiteness and normalisation, and the L=256 request
     is recomputed on the plain path on the card;
  5. a `kernels` JSON line, then {"ok": true, "device": {...}} last.

It exits non-zero, printing no result, where CUDA is unavailable or the
port is not beside it.
"""
from __future__ import annotations

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
    return requests, launches


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
    logs = _build.build(["triangle_attention"])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kernel_rows = kernel_phase(dev, peaks)

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        requests, launches = main_path(dev, WORK)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    at_max = [r for r in kernel_rows if r["L"] == max(KERNEL_LENGTHS)]
    mean = lambda key: sum(r[key] for r in at_max) / len(at_max)
    print(json.dumps({"kernels": [{
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where a geometry request's time goes in the PyTorch/CUDA port.

Runs one geometry-stage request (a3m -> features -> Predictor2D for both
models -> pred_npz) at full width with seeded random weights, twice (cold,
then warm), on one CUDA device, and prints:
  - wall seconds per stage of the warm request: MSA read, weight load,
    features, trunk forward, softmax + copy to host, npz write;
  - device milliseconds per module class inside one warm forward (CUDA
    events from forward hooks; nested classes are not double counted);
  - the device's busy share over the warm forward and the kernels that
    take the most device time (torch.profiler).

The request is chip_smoke.py's largest: L=400, 1000 MSA rows, depth 12.
Usage (from the repository root, on a machine with a CUDA device):
    python3 scripts/port_profile.py
"""
from __future__ import annotations

import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from trx2dy_torch.device import resolve_device  # noqa: E402
from trx2dy_torch.dynamics.driver import WEIGHT_FILES  # noqa: E402
from trx2dy_torch.models import predictor2d as p2d  # noqa: E402
from trx2dy_torch.models.convert import build_model, load_params  # noqa: E402
from trx2dy_torch.models.features import get_f2d  # noqa: E402
from trx2dy_torch.models.predictor2d_infer import (  # noqa: E402
    MSA_CUTOFF, read_msa,
)
from trx2dy_torch.utils.profiling import device_work  # noqa: E402

L, ROWS, DEPTH = 400, 1000, 12
HOOKED = (p2d.TriangleAttention, p2d.TriangleMultiplication, p2d.Bottle2neck,
          p2d.PairTransition, p2d.MSAAttention, p2d.UpdateX, p2d.UpdateM,
          p2d.FeedForward)


def _sync_time(t0):
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def staged_request(dev, a3m: Path, model_dir: Path, out_dir: Path):
    """One request with a synchronised clock around every stage."""
    t = defaultdict(float)
    t0 = time.perf_counter()
    msa = read_msa(str(a3m))
    t["read_msa"] += time.perf_counter() - t0
    for tag, fname in WEIGHT_FILES.items():
        t0 = time.perf_counter()
        model = build_model(load_params(str(model_dir / fname)), dev)
        t["load_weights"] += _sync_time(t0)
        with torch.inference_mode():
            t0 = time.perf_counter()
            tokens = torch.as_tensor(msa.astype(np.int64), device=dev)
            f2d = get_f2d(tokens)
            t["features"] += _sync_time(t0)
            t0 = time.perf_counter()
            logits = model(f2d, tokens[:MSA_CUTOFF])
            t["forward"] += _sync_time(t0)
            t0 = time.perf_counter()
            labels = {k: torch.softmax(v, -1).cpu().numpy()
                      for k, v in logits.items()}
            t["softmax_to_host"] += _sync_time(t0)
        t0 = time.perf_counter()
        np.savez_compressed(out_dir / f"t_{tag}.npz", **labels)
        t["write_npz"] += time.perf_counter() - t0
    return dict(t), model, f2d, tokens


def module_times(model, f2d, tokens):
    """Device ms per hooked module class over one forward."""
    events = []   # (class name, start event, end event) of outermost calls
    depth = [0]   # hooked modules open; nested ones count toward the outer

    def record():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def pre(mod, args):
        depth[0] += 1
        if depth[0] == 1:
            events.append([type(mod).__name__, record(), None])

    def post(mod, args, out):
        depth[0] -= 1
        if depth[0] == 0:
            events[-1][2] = record()

    handles = []
    for m in model.modules():
        if isinstance(m, HOOKED):
            handles.append(m.register_forward_pre_hook(pre))
            handles.append(m.register_forward_hook(post))
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.inference_mode():
            start.record()
            model(f2d, tokens[:MSA_CUTOFF])
            end.record()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    by_class = defaultdict(float)
    for name, a, b in events:
        by_class[name] += a.elapsed_time(b)
    return start.elapsed_time(end), dict(by_class)


def profiler_summary(model, f2d, tokens, top: int = 12):
    """Wall ms of one profiled forward, the ms in which at least one kernel
    ran (union of kernel intervals), and the kernels by total time."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(f2d, tokens[:MSA_CUTOFF])
        wall = _sync_time(t0)
    return (1e3 * wall, *kernel_summary(prof.events(), top))


def kernel_summary(events, top: int = 12):
    """The ms in which at least one kernel ran (union of kernel intervals)
    and the `top` kernels by total time, of a trace's events(); the spans'
    device-side copies are not kernels (profiling.device_work)."""
    kernels = device_work(events)
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    totals = defaultdict(lambda: [0, 0.0])
    for k in kernels:
        totals[k.name][0] += 1
        totals[k.name][1] += k.time_range.elapsed_us()
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][1])[:top]
    return busy_us / 1e3, [
        (name[:90], n, us / 1e3) for name, (n, us) in ranked]


def main() -> int:
    if not torch.cuda.is_available():
        print("port_profile: needs a CUDA device", file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}")
    work = ROOT / "build" / "profile"
    work.mkdir(parents=True, exist_ok=True)
    chip_smoke.write_models(work, DEPTH)
    a3m = work / "t.a3m"
    chip_smoke.write_synthetic_a3m(a3m, L, ROWS, seed=L)

    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        stages, model, f2d, tokens = staged_request(dev, a3m, work, work)
        total = time.perf_counter() - t0
        print(f"{label} request L={L} R={ROWS}: {total:.3f} s; "
              + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()))

    fwd_ms, by_class = module_times(model, f2d, tokens)
    print(f"one warm forward: {fwd_ms:.1f} ms device time between events")
    for name, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {name:24s} {ms:9.1f} ms  {100 * ms / fwd_ms:5.1f} %")
    wall_ms, busy_ms, top = profiler_summary(model, f2d, tokens)
    print(f"profiled forward: wall {wall_ms:.1f} ms, a kernel running "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    for key, count, ms in top:
        print(f"  {ms:9.1f} ms  x{count:<5d} {key}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

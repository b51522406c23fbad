"""One run of one cell: set-up, the measured window, the check.

The kind of traffic (benchmarks/kinds/<kind>.py) supplies the system
under test: `setup(ctx)` builds it from the seed and warms up every shape
the cell uses, and returns a driver with

- `round(rec)`: one pass of the traffic (a round of requests, or of
  train steps), returning a Unit per request or step;
- `free()`: drops the program's state;
- `check()`: {number: value}, what the window produced against the plain
  reference (each number is compared with its limit, lower is better).

The window runs whole rounds until `seconds` have passed. With trace on,
its first round runs under torch.profiler, and at least one round more
runs after it; the per-layer readers see every unit and the reduced
trace.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Optional

import torch

from harness import manifest
from harness.peaks import peaks_for
from harness.trace import Events, summarize


@dataclass
class Unit:
    """One request or step of the window."""
    t0: float                   # host clock at its start and end
    t1: float
    flops: float                # model FLOPs (harness.counts)
    attn_bounds_s: list = field(default_factory=list)  # per kernel launch
    spans: dict = field(default_factory=dict)   # name -> ms or event ids
    profiled: bool = False


class Recorder:
    """What a driver needs while it runs a round: the clock, CUDA events
    for spans, and whether this round is traced."""

    def __init__(self, device, trace: bool):
        self.events = Events(device)
        self.trace = trace
        self.profiled = False

    def resolve(self, units) -> None:
        """Event ids -> ms, summed per span name (after a sync)."""
        for u in units:
            u.spans = {k: (sum(self.events.ms(i) for i in v)
                           if isinstance(v, list) else v)
                       for k, v in u.spans.items()}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def choose_device(chips: int, allow_cpu: bool):
    if torch.cuda.is_available() and torch.cuda.device_count() >= chips:
        return torch.device("cuda", 0)
    if allow_cpu:
        return torch.device("cpu")
    raise SystemExit(
        f"needs {chips} CUDA device(s); torch.cuda.is_available() is "
        f"{torch.cuda.is_available()}, device_count() "
        f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")


def device_info(device, chips: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        t_start: float, allow_cpu: bool = False, fault: Optional[str] = None,
        overrides: Optional[dict] = None,
        control: Optional[str] = None) -> dict:
    """One run; returns the result line's object. overrides: {"config":
    {...}, "traffic": {...}} merged into the cell's files (tests only);
    fault: a fault planted in the timed path (tests only); control: a
    plainref.lowp precision whose reference is also compared, as the
    control of `correct` ("control_checks"; calibrate.py only)."""
    cell = manifest.cell(manifest.load(), cell_name)
    for part in ("config", "traffic"):
        cell[part] = _merge(cell[part], (overrides or {}).get(part))
    device = choose_device(cell["chips"], allow_cpu)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "H100 SXM"
    marks = []
    ctx = SimpleNamespace(cell=cell, config=cell["config"],
                          traffic=cell["traffic"], seed=seed, device=device,
                          peaks=peaks_for(name, cell["config"]["precision"]),
                          fault=fault,
                          mark=lambda what: marks.append(
                              (what, time.perf_counter())))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_driver = time.perf_counter()
    driver = manifest.kind(cell["traffic"]).setup(ctx)
    sync(device)
    setup_s = time.perf_counter() - t_start

    rec = Recorder(device, trace)
    units, rounds, summary, ends = [], 0, None, []
    t0 = time.perf_counter()
    while True:
        if trace and rounds == 0:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with profile(activities=acts) as prof:
                rec.profiled = True
                a = time.perf_counter()
                units += driver.round(rec)
                sync(device)
                window = time.perf_counter() - a
            rec.profiled = False
        else:
            units += driver.round(rec)
        rounds += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds and (not trace or rounds > 1):
            break
    sync(device)
    window_s = time.perf_counter() - t0
    info = device_info(device, cell["chips"])
    rec.resolve(units)
    if trace:
        summary = summarize(prof, window)
        del prof

    rctx = SimpleNamespace(units=units, window_s=window_s, setup_s=setup_s,
                           rounds=rounds, trace=summary, peaks=ctx.peaks,
                           config=cell["config"], traffic=cell["traffic"])
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in wanted:
        value = manifest.reader(m["name"]).read(rctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_check = time.perf_counter()
    driver.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = driver.check(control)
    control_numbers = numbers.pop("control", None)
    checks, correct = {}, True
    for key, value in numbers.items():
        limit = cell["limits"][key]
        ok = math.isfinite(value) and value <= limit
        # JSON has no infinity: a gap that could not be read is a string
        checks[key] = {"value": value if math.isfinite(value)
                       else str(value), "limit": limit}
        correct = correct and ok
    split, last = [], t_driver
    for what, t in marks:
        split.append(f"{what} {t - last:.2f}")
        last = t
    print(f"run {cell_name} seed {seed}: set-up {setup_s:.2f} s (before "
          f"the driver {t_driver - t_start:.2f} s; {', '.join(split)}), "
          f"window "
          f"{window_s:.2f} s ({rounds} rounds of "
          f"{[round(b - a, 3) for a, b in zip([0.0] + ends, ends)]} s, "
          f"{len(units)} units), check "
          f"{time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    out = {"correct": bool(correct), "attempted": len(units), "failed": 0,
           "metrics": metrics, "device": info}
    if trace:
        out["device"]["busy_s"] = summary["busy_s"]
        out["device"]["window_s"] = summary["window_s"]
        out["breakdown"] = summary["breakdown"]
    if control_numbers is not None:
        out["control_checks"] = {
            k: {"value": v if math.isfinite(v) else str(v),
                "limit": cell["limits"][k]}
            for k, v in control_numbers.items()}
    out["checks"] = checks
    return out

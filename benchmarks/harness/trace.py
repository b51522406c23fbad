"""Spans around the program's layers, and the reduction of a profiler
trace to device busy time, kernel times and the breakdown.

The benchmark records its spans from its own files, around the calls
into each layer (a span inside the program is the tracing issue's):
`label` opens a torch.profiler range that the trace shows, and
`ModuleSpan` times a run of modules with CUDA events from forward hooks.
Labels carry the prefix "bench:" so the reduction finds them among the
host's operations.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

PREFIX = "bench:"
TOP = 10


@contextlib.contextmanager
def label(name: str, on: bool = True):
    """A named range in the profiler's trace (nothing when off)."""
    if not on:
        yield
        return
    with torch.profiler.record_function(PREFIX + name):
        yield


class Events:
    """Device time between pairs of CUDA events, read after a sync; on
    the CPU the host clock between the same calls, after nothing."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.pairs = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, start, end) -> int:
        self.pairs.append((start, end))
        return len(self.pairs) - 1

    def ms(self, i: int) -> float:
        a, b = self.pairs[i]
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)


class ModuleSpan:
    """Times from the start of `first`'s forward to the end of `last`'s,
    once per call, with CUDA events; `take()` returns the indices of the
    spans recorded since the last take. Also opens a profiler label over
    the same stretch of the host."""

    def __init__(self, events: Events, first, last, name: str):
        self.events, self.name, self.open = events, name, None
        self.pending = []
        self.handles = [first.register_forward_pre_hook(self._pre),
                        last.register_forward_hook(self._post)]

    def _pre(self, mod, args):
        rf = torch.profiler.record_function(PREFIX + self.name)
        rf.__enter__()
        self.open = (self.events.mark(), rf)

    def _post(self, mod, args, out):
        start, rf = self.open
        self.pending.append(self.events.add(start, self.events.mark()))
        rf.__exit__(None, None, None)
        self.open = None

    def take(self) -> list:
        out, self.pending = self.pending, []
        return out

    def remove(self):
        for h in self.handles:
            h.remove()


def _split(prof):
    """(the device's own operations: kernels, copies and sets; the
    benchmark's labels on the host as (start, end, name)). The device-side
    copies of host ranges (user annotations: the benchmark's labels,
    torch.optim's "Optimizer.step#...") carry a host range's name, and are
    not device work."""
    from torch.autograd import DeviceType
    events = prof.events()
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name != "Command Buffer Full" and e.name not in host
              and not e.name.startswith(PREFIX)]
    labels = sorted((e.time_range.start, e.time_range.end,
                     e.name[len(PREFIX):])
                    for e in events if e.device_type == DeviceType.CPU
                    and e.name.startswith(PREFIX))
    return device, labels


def summarize(prof, window_s: float) -> dict:
    """busy_s (the union of device activity), window_s, kernel totals by
    name {name: [launches, seconds]} and the breakdown: the device
    operations that took most time, and the idle gaps between device
    activity summed by the innermost benchmark label the host was in."""
    events, labels = _split(prof)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, end = 0.0, float("-inf")
    gaps = []
    for s, e in spans:
        if s > end and end > float("-inf"):
            gaps.append((end, s))
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    kernels = defaultdict(lambda: [0, 0.0])
    for e in events:
        kernels[e.name][0] += 1
        kernels[e.name][1] += e.time_range.elapsed_us() / 1e6
    idle = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [lab for lab in labels if lab[0] <= mid <= lab[1]]
        name = max(inner)[2] if inner else "outside any label"
        idle[name] += (b - a) / 1e6
    ops = sorted(((k, v[1]) for k, v in kernels.items()),
                 key=lambda kv: -kv[1])[:TOP]
    gaps_by = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "kernels": {k: list(v) for k, v in kernels.items()},
            "breakdown": {"device_ops": [[k[:120], s] for k, s in ops],
                          "idle_gaps": [[k, s] for k, s in gaps_by]}}


def kernel_time(summary: dict, needle: str) -> tuple:
    """(launches, device seconds) of the kernels whose name holds
    `needle`."""
    n, s = 0, 0.0
    for name, (count, secs) in summary["kernels"].items():
        if needle in name:
            n, s = n + count, s + secs
    return n, s

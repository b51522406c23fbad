"""What the per-layer and end-to-end metric readers share.

Each metric's own reader (benchmarks/metrics/<name>.py) is a few lines
that call one of these on the run's context: `units` (every request or
step of the window, with its host times, model FLOPs, attention bounds
and spans), `window_s`, `setup_s`, `trace` (harness.trace.summarize of
the profiled round, or None) and `peaks`. A reader that finds nothing to
read returns None, and the metric is left out of the line.
"""
from __future__ import annotations

from harness.trace import kernel_time


def mfu(ctx):
    """Model FLOPs of the units outside the profiled round over their
    wall time, as a share (%) of the precision's peak."""
    units = [u for u in ctx.units if not u.profiled]
    wall = sum(u.t1 - u.t0 for u in units)
    if not units or wall <= 0:
        return None
    return 100.0 * sum(u.flops for u in units) / wall / ctx.peaks["flops"]


def span_mean(ctx, name: str):
    """The mean of a span (ms) over the units that carry it."""
    vals = [u.spans[name] for u in ctx.units if name in u.spans]
    return sum(vals) / len(vals) if vals else None


def roofline(ctx, kernel: str):
    """The bound of every launch of `kernel` in the profiled round over
    the device time the trace gives its launches (%); None where the
    trace shows none, or not as many as the units launched."""
    if ctx.trace is None:
        return None
    n, secs = kernel_time(ctx.trace, kernel)
    bounds = [b for u in ctx.units if u.profiled for b in u.attn_bounds_s]
    if n == 0 or secs <= 0 or n != len(bounds):
        return None
    return 100.0 * sum(bounds) / secs


def idle(ctx):
    """The share (%) of the profiled round in which no device operation
    ran."""
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])

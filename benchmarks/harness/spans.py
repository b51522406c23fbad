"""The program's own spans (trx2dy_torch.utils.profiling.span) in the
profiled round.

A profiler session turns the port's spans on, so the round that runs
under torch.profiler records them and no other round does. The first
reader that asks takes them with `collect()` (one device sync, after the
window) and keeps them on the reader's context for the others. A program
without spans gives None, and its metrics are left out of the line.
"""
from __future__ import annotations


def records(ctx):
    """The span records of the run, taken once; None where the program
    has no span API."""
    if not hasattr(ctx, "span_records"):
        try:
            from trx2dy_torch.utils.profiling import collect
        except ImportError:
            collect = None
        ctx.span_records = collect() if collect is not None else None
    return ctx.span_records


def per_unit(ctx, name: str, parent: str, clock: str = "device"):
    """The ms of every span `name` directly under a span `parent` in the
    profiled round, summed, over the round's units; clock "device"
    (between the span's CUDA events) or "host". None where there is no
    such span."""
    recs = records(ctx)
    n = sum(1 for u in ctx.units if u.profiled)
    if not recs or n == 0:
        return None
    picked = [r for r in recs if r.name == name and r.parent is not None
              and r.parent.name == parent]
    if not picked:
        return None
    key = "device_ms" if clock == "device" else "host_ms"
    return sum(getattr(r, key) for r in picked) / n

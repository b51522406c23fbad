"""Device waits, a torch.profiler trace, and spans over the port's layers.

PyTorch counterpart of trx2dy/utils/profiling.py. CUDA work is
asynchronous: a clock stopped before the device has finished measures the
enqueue. block_all waits for the devices of the tensors it is given;
torch_trace takes the place of xla_trace.

Two timers, for two uses:

- device.StageTimer (the predict and train CLIs' `timings`) syncs the
  device at the end of every stage, so that each stage's host seconds
  hold its own device work. It drains the queue it times: read it for a
  run's coarse split, not under a profiler.
- `span(name)` marks where a layer's work is issued, and syncs nothing.
  The spans are `features`, `trunk`, `heads`, `output` and `geometry`
  (predict_geometry), `esm`, `folding` with its `recycle` and
  `structure` (each cycle), and the train step's `train_step` with its
  `forward`, `backward` and `optimizer`. They are off unless a
  torch.profiler session records (torch_trace, or any `profile`) or
  `tracing(True)` holds them on in its thread; off, a span costs one
  check. On, each opens a profiler range "trx2dy.<name>" (on the
  profiler's clock, beside the kernels it issues), and records the host
  clock and, once CUDA is in use, a pair of CUDA events on the current
  stream; its device ms is the time between them, waits for the host
  included. `collect()` syncs
  once and returns the finished spans with their host and device ms;
  `idle_by_span(prof)` splits a trace's device idle by the innermost
  span the host was in. A span's range leaves a device-side copy of
  itself over its kernels in the trace: `device_work(events)` leaves
  such copies out, and whatever sums or merges device events takes them
  through it.
"""
from __future__ import annotations

import contextlib
import threading
import time
import warnings
from collections import defaultdict

import torch

PREFIX = "trx2dy."
OUTSIDE = "outside any span"

_profiler_enabled = torch._C._autograd._profiler_enabled


def _cuda_devices(tree, out: set) -> set:
    if torch.is_tensor(tree):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def block_all(tree):
    """Wait for the devices of every CUDA tensor in a nest of dicts, lists
    and tuples; returns the nest."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)
    return tree


@contextlib.contextmanager
def torch_trace():
    """torch.profiler around a block, of the host and, where there is one,
    the CUDA device; yields the profiler (key_averages(), events(),
    export_chrome_trace()). The port's spans are on inside it."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


# --------------------------------------------------------------------------
# spans
# --------------------------------------------------------------------------

MAX_RECORDS = 1 << 16


class _Log:
    """The process's spans: those recorded and not yet collected; and, per
    thread, the open ones and the switch that tracing() sets."""

    def __init__(self):
        self.records = []
        self.dropped = 0
        self.local = threading.local()

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def trim(self) -> None:
        """Drops the older half of the finished spans: MAX_RECORDS wait
        uncollected (a long profiler session that nobody collects), and
        each holds two CUDA events."""
        done = [r for r in self.records if r._t1 is not None]
        gone = {id(r) for r in done[:len(done) // 2]}
        self.records = [r for r in self.records if id(r) not in gone]
        if gone and not self.dropped:
            warnings.warn(f"{MAX_RECORDS} spans left uncollected: dropping "
                          "the oldest (call profiling.collect())")
        self.dropped += len(gone)


_LOG = _Log()


class SpanRecord:
    """One span: `name`, the enclosing span `parent` (None at a root), the
    outermost enclosing span `root` (itself at a root: one request or one
    step), and after collect() `host_ms` and `device_ms` (the time between
    its CUDA events on the stream that issued its work; the host's ms
    where CUDA was not in use)."""

    __slots__ = ("name", "parent", "root", "host_ms", "device_ms",
                 "_range", "_t0", "_t1", "_events")

    def __init__(self, name: str):
        self.name = name
        self.host_ms = self.device_ms = None
        self._t1 = self._events = None

    def __enter__(self):
        stack = _LOG.stack()
        self.parent = stack[-1] if stack else None
        self.root = self if self.parent is None else self.parent.root
        stack.append(self)
        if len(_LOG.records) >= MAX_RECORDS:
            _LOG.trim()
        _LOG.records.append(self)
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        if torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        self._t1 = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _LOG.stack().pop()
        return False


class _Off:
    """What span() returns while spans are off: enters and leaves, records
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """`with span("trunk"):` marks a layer's work as issued by the host.
    Off unless a profiler session records or tracing(True) holds; see the
    module's docstring."""
    forced = getattr(_LOG.local, "forced", None)
    on = _profiler_enabled() if forced is None else forced
    return SpanRecord(name) if on else _OFF


@contextlib.contextmanager
def tracing(on: bool):
    """Spans on (True) or off (False) inside the block, in this thread,
    whether or not a profiler records; tracing(False) under a profiler
    measures what the spans cost there."""
    local = _LOG.local
    before, local.forced = getattr(local, "forced", None), bool(on)
    try:
        yield
    finally:
        local.forced = before


def collect() -> list:
    """The spans finished since the last collect(), in the order they
    opened, with host_ms and device_ms filled in; spans still open stay
    for the next call. Syncs the current CUDA device once where a span
    recorded CUDA events, and nowhere else."""
    done = [r for r in _LOG.records if r._t1 is not None]
    _LOG.records = [r for r in _LOG.records if r._t1 is None]
    if any(r._events is not None for r in done):
        torch.cuda.synchronize()
    for r in done:
        r.host_ms = (r._t1 - r._t0) / 1e6
        r.device_ms = r.host_ms if r._events is None \
            else r._events[0].elapsed_time(r._events[1])
        r._events = r._range = None
    return done


# --------------------------------------------------------------------------
# device idle by span
# --------------------------------------------------------------------------

def _innermost(ranges) -> list:
    """Nested (start, end, name) host ranges -> sorted, disjoint (start,
    end, name) pieces, each named after the range that began last among
    those covering it (the shorter of two that began together)."""
    ranges = [r for r in ranges if r[1] > r[0]]
    edges = sorted([(e, 0, i) for i, (_, e, _) in enumerate(ranges)]
                   + [(s, 1, i) for i, (s, _, _) in enumerate(ranges)])
    pieces, active, prev = [], {}, None
    for t, opens, i in edges:
        if active and t > prev:
            inner = max(active,
                        key=lambda j: (ranges[j][0], -ranges[j][1]))
            pieces.append((prev, t, ranges[inner][2]))
        if opens:
            active[i] = True
        else:
            active.pop(i, None)
        prev = t
    return pieces


def _split_gaps(gaps, pieces) -> dict:
    """Each gap's length spread over the pieces it overlaps (both lists
    sorted and disjoint); what no piece covers goes to OUTSIDE."""
    out = defaultdict(float)
    j = 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, name = pieces[k]
            part = min(b, e) - max(a, s)
            if part > 0:
                out[name] += part
                covered += part
            k += 1
        if b - a - covered > 0:
            out[OUTSIDE] += b - a - covered
    return dict(out)


def device_work(events) -> list:
    """The device's own work among a trace's events() or key_averages():
    its kernels, copies and sets. A profiler range (a span, or any
    record_function) leaves a device-side copy of itself over the kernels
    it issued; that copy is marked a user annotation, or carries a host
    event's name, and is left out, as is the profiler's "Command Buffer
    Full" marker. Sum or merge only these as device time."""
    from torch.autograd import DeviceType
    events = list(events)
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.key not in host and e.key != "Command Buffer Full"]


def idle_by_span(prof) -> dict:
    """{span name: seconds}: the gaps between device operations in a
    torch_trace() (or a list of its events()), each split by the innermost
    span the host was in meanwhile; OUTSIDE for the rest. Only
    device_work() counts as device operations. Empty for a trace with no
    CUDA activity."""
    from torch.autograd import DeviceType
    events = list(prof.events() if hasattr(prof, "events") else prof)
    ops = sorted((e.time_range.start, e.time_range.end)
                 for e in device_work(events))
    gaps, end = [], None
    for s, e in ops:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    spans = [(e.time_range.start, e.time_range.end, e.name[len(PREFIX):])
             for e in events if e.device_type == DeviceType.CPU
             and e.name.startswith(PREFIX)]
    split = _split_gaps(gaps, _innermost(spans))
    return {k: v / 1e6 for k, v in
            sorted(split.items(), key=lambda kv: -kv[1])}

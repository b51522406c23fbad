"""Masked spline restraint energy: the CUDA kernel, its plain versions, the
wrappers.

The kernel (csrc/spline_energy.cu) replaces the Pallas TPU kernel
trx2dy/ops/spline_energy.py:_spline_kernel. Per decoy it sums a masked
natural-cubic spline over its queries and returns dE/dq in the same pass,
so each wrapper is an autograd Function whose backward is `g * deriv`.
Three entry points:

  spline_energy_dense_terms(tables, qs)  tables: SplineDense of up to four
      terms, each y, m (L, L, K_t), x (K_t,), mask (L, L) bool; qs: one
      (B, L, L) query tensor per term -> (n_terms, B), one launch for all
      terms. The TPU kernel's layout (spline_energy_batch), run by
      energy.batched_energy_dense (the single-program fold's evaluation)
      and batched_energy_fused; restraints.dense_splines builds the
      SplineDense once per stage. spline_energy_dense(y, m, x, q, mask) is
      its one-term call (B,).
  spline_energy_pairs(tables, qs)        tables: SplinePairs of up to four
      terms, each y, m (P_t, K_t), x (K_t,), act (P_t,) bool; qs: one
      (P_t, B) query tensor per term -> (n_terms, B), one launch for all
      terms. The compacted pair lists of the production fold
      (compact.compact_restraint_energy_batch); compact.compact_to builds
      the SplinePairs once per stage, which is where the tables are checked.
  spline_energy_lanes(tables, qs)        tables: SplineLanes of up to four
      terms, each an interval table tab (P_t, U_t, K_t - 1, 4), a lane ->
      row map row (C,) int32, x (K_t,) and act (P_t, C) bool; qs: one
      (P_t, C) query tensor per term -> (n_terms, C), one launch for all
      terms. The Dynamics sampler's shared pair list with a table per lane
      (compact.compact_restraint_energy_union, the port of
      spline.masked_spline_energy_lanes): lane c of pair p evaluates
      tab[p, row[c]], so lanes folded from one histogram share one stored
      table. Interval k of a table row holds (y[k], y[k+1], m[k], m[k+1])
      (interval_tables), which the kernel reads as one 16-byte load.
      Tables, activity and queries are pair-major, the layout
      physics/tablegen.py emits, so no evaluation transposes anything;
      compact.union_stage builds the SplineLanes once per protocol stage
      of a sampler step.

Knots have K <= 64 and tensors are float32 on the card. A CPU tensor takes
the plain version (the port of spline.evaluate_spline_with_deriv or
_eval_with_deriv_pb); a CUDA tensor launches the kernel or raises.
`spline_energy_dense.launches` (the dense entry, both calls),
`spline_energy_pairs.launches` and `spline_energy_lanes.launches` count
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from trx2dy_torch.physics.spline import (
    SplineTable, _cubic, _eval_with_deriv_pb, _interval,
    evaluate_spline_with_deriv,
)

MAX_K = 64
MAX_TERMS = 4     # terms of one pair launch


def spline_dense_plain(y, m, x, q, mask):
    """(per-decoy masked sums (B,), masked deriv (B, L, L)) in PyTorch."""
    val, der = evaluate_spline_with_deriv(SplineTable(x, y, m), q)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    return (torch.sum(torch.where(mask, val, zero), dim=(1, 2)),
            torch.where(mask, der, zero))


def spline_dense_terms_plain(terms, qs):
    """(per-decoy masked sums (n_terms, B), each term's masked deriv
    (B, L, L)) in PyTorch: spline_dense_plain per term; terms holds
    (y, m, x, mask) per term."""
    out = [spline_dense_plain(y, m, x, q, mask)
           for (y, m, x, mask), q in zip(terms, qs)]
    return torch.stack([o[0] for o in out]), tuple(o[1] for o in out)


def spline_pairs_plain(terms, qs):
    """(per-decoy masked sums (n_terms, B), each term's masked deriv
    (P_t, B)) in PyTorch; terms holds (y, m, x, act) per term."""
    sums, derivs = [], []
    for (y, m, x, act), q in zip(terms, qs):
        val, der = _eval_with_deriv_pb(y, m, x, q)
        zero = torch.zeros((), dtype=q.dtype, device=q.device)
        keep = act[:, None]
        sums.append(torch.sum(torch.where(keep, val, zero), dim=0))
        derivs.append(torch.where(keep, der, zero))
    return torch.stack(sums), tuple(derivs)


def interval_tables(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The lanes entry's storage of spline tables y, m (..., K): (..., K-1,
    4) with interval k holding (y[k], y[k+1], m[k], m[k+1]), contiguous."""
    return torch.stack([y[..., :-1], y[..., 1:], m[..., :-1], m[..., 1:]],
                       dim=-1).contiguous()


def expand_lane_tables(tab: torch.Tensor, row: torch.Tensor):
    """Per-lane y, m (P, C, K) of an interval table tab (P, U, K-1, 4) under
    the lane -> row map row (C,): the layout the lanes entry no longer
    stores, for comparisons."""
    t = tab.index_select(1, row.to(torch.int64))
    y = torch.cat([t[..., 0], t[..., -1:, 1]], dim=-1)
    m = torch.cat([t[..., 2], t[..., -1:, 3]], dim=-1)
    return y, m


def spline_lanes_plain(terms, qs):
    """(per-lane masked sums (n_terms, C), each term's masked deriv
    (P_t, C)) in PyTorch; terms holds (tab, row, x, act) per term. Each
    query gathers its interval's four values from tab[p, row[c]] (queries
    outside the knots the first or last interval, whose values give the
    boundary slope) and evaluates them as evaluate_spline_with_deriv does
    per-lane tables, with the same result to the bit."""
    sums, derivs = [], []
    for (tab, row, x, act), q in zip(terms, qs):
        P, U, n, _ = tab.shape
        k = _interval(x, q)                                   # (P, C)
        at = (torch.arange(P, device=q.device)[:, None] * U
              + row.to(torch.int64)) * n + k
        ya, yb, ma, mb = tab.reshape(-1, 4)[at].unbind(-1)
        val, der = _cubic(q, x[k], x[k + 1], ya, yb, ma, mb)
        h0, hn = x[1] - x[0], x[-1] - x[-2]
        slope_lo = (yb - ya) / h0 - h0 * (2.0 * ma + mb) / 6.0
        slope_hi = (yb - ya) / hn + hn * (ma + 2.0 * mb) / 6.0
        lo, hi = q < x[0], q > x[-1]
        val = torch.where(lo, ya + slope_lo * (q - x[0]), torch.where(
            hi, yb + slope_hi * (q - x[-1]), val))
        der = torch.where(lo, slope_lo, torch.where(hi, slope_hi, der))
        zero = torch.zeros((), dtype=q.dtype, device=q.device)
        sums.append(torch.sum(torch.where(act, val, zero), dim=0))
        derivs.append(torch.where(act, der, zero))
    return torch.stack(sums), tuple(derivs)


class _PairTerm(ctypes.Structure):
    """csrc/spline_energy.cu:PairTerm, one term's stage constants."""
    _fields_ = [("y", ctypes.c_void_p), ("m", ctypes.c_void_p),
                ("x", ctypes.c_void_p), ("act", ctypes.c_void_p),
                ("row", ctypes.c_void_p), ("P", ctypes.c_longlong),
                ("K", ctypes.c_int), ("U", ctypes.c_int)]


def _lib():
    from trx2dy_torch.ops import _build
    lib = _build.load("spline_energy")
    if lib.trx2dy_spline_dense.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for entry in ("dense", "pairs", "lanes"):
            size = getattr(lib, f"trx2dy_spline_{entry}_buffer")
            size.argtypes, size.restype = [vp, i, i, i, vp], ll
            launch = getattr(lib, f"trx2dy_spline_{entry}")
            launch.argtypes = [vp, i, vp, i, vp, vp, i, vp]
            launch.restype = ctypes.c_int
    return lib


def _check_tables(terms, entry: str = "spline_energy_pairs",
                  kind: str = "pairs") -> None:
    """Raise ValueError unless `terms` are 1..MAX_TERMS tuples that the
    entry takes, all contiguous and on one device, of the knots' floating
    dtype (float32 on a CUDA device): knots x (K,) with 2 <= K <= MAX_K;
    for the pair entry (y, m, x, act) with tables y, m (P, K) and act (P,)
    bool; for the lanes entry (tab, row, x, act) with a 16-byte aligned
    interval table tab (P, U, K-1, 4), a lane -> row map row (C,) int32 and
    act (P, C) bool, one C for all terms; for the dense entry (y, m, x,
    mask) with tables y, m (L, L, K), 16-byte aligned on a CUDA device, and
    mask (L, L) bool, one L for all terms. The lanes map's values must lie
    in [0, U): tablegen.compile and compact.union_take_lanes make it so,
    and reading it here would cost a host sync."""
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"{entry}: 1 to {MAX_TERMS} terms, "
                         f"got {len(terms)}")
    dev = terms[0][0].device
    lanes, dense = kind == "lanes", kind == "dense"
    C = terms[0][1].shape[0] if lanes and terms[0][1].dim() == 1 else 0
    L = terms[0][3].shape[0] if dense and terms[0][3].dim() == 2 else 0
    for n, (a, b, x, act) in enumerate(terms):
        name = f"{entry} term {n}"
        K = x.shape[0] if x.dim() == 1 else -1
        if not 2 <= K <= MAX_K:
            raise ValueError(f"{name}: knots must be (K,) with 2 <= K <= "
                             f"{MAX_K}, got {tuple(x.shape)}")
        aname = "mask" if dense else "act"
        if lanes:
            P = a.shape[0] if a.dim() == 4 else 0
            U = a.shape[1] if a.dim() == 4 else 0
            shapes = (("tab", a, (P, U, K - 1, 4)), ("row", b, (C,)),
                      ("act", act, (P, C)))
            dtypes = (("tab", a, x.dtype), ("row", b, torch.int32))
            ok = P >= 1 and U >= 1 and C >= 1
        elif dense:
            shapes = (("y", a, (L, L, K)), ("m", b, (L, L, K)),
                      ("mask", act, (L, L)))
            dtypes = (("y", a, x.dtype), ("m", b, x.dtype))
            ok = L >= 1
        else:
            P = a.shape[0] if a.dim() == 2 else 0
            shapes = (("y", a, (P, K)), ("m", b, (P, K)), ("act", act, (P,)))
            dtypes = (("y", a, x.dtype), ("m", b, x.dtype))
            ok = P >= 1
        for tname, t, shape in shapes:
            if not ok or tuple(t.shape) != shape:
                raise ValueError(f"{name}: {tname} must be {shape} with "
                                 f"P, U, C, L >= 1, got {tuple(t.shape)}")
        floats = (torch.float32,) if dev.type == "cuda" else (
            torch.float32, torch.float64)
        if x.dtype not in floats:
            raise ValueError(f"{name}: tables must be one of {floats} on "
                             f"{dev}, got {x.dtype}")
        for tname, t, want in dtypes + (("x", x, x.dtype),
                                        (aname, act, torch.bool)):
            if t.device != dev or t.dtype != want:
                raise ValueError(f"{name}: {tname} must be {want} on {dev}, "
                                 f"got {t.dtype} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {tname} must be contiguous")
        if lanes and a.data_ptr() % 16:
            raise ValueError(f"{name}: tab must be 16-byte aligned (one "
                             "float4 per interval)")
        if dense and dev.type == "cuda" and (a.data_ptr() % 16
                                             or b.data_ptr() % 16):
            raise ValueError(f"{name}: y and m must be 16-byte aligned "
                             "(four floats per load)")


class SplinePairs:
    """The stage constants of the pair entry: per term (y, m, x, act),
    checked once when built (compact.compact_to builds one per stage), so
    each evaluation checks only its queries."""

    entry = "spline_energy_pairs"
    kind = "pairs"        # the C functions trx2dy_spline_<kind>[_buffer]

    def __init__(self, terms):
        terms = tuple(tuple(t) for t in terms)
        _check_tables(terms, self.entry, self.kind)
        self.terms = terms
        self.device = terms[0][0].device
        self.sizes = tuple(y.shape[0] for y, _, _, _ in terms)   # P_t
        self._c = None        # ctypes PairTerm array, at the first launch
        self._qptrs = None    # ctypes array of the query pointers
        self._layout = {}     # B -> (work buffer's part sizes, counters)

    def _batch(self, qs) -> int:
        """B of these queries (the lanes entry's C)."""
        return qs[0].shape[-1]

    def _query_shape(self, P: int, B: int) -> tuple:
        """Each query's and deriv's shape for a term of P pairs."""
        return (P, B)

    def _launch_constants(self, lib):
        if self._c is None:
            self._c = (_PairTerm * len(self.terms))(*(
                self._pair_term(*t) for t in self.terms))
            self._qptrs = (ctypes.c_void_p * len(self.terms))()
        return self._c

    @staticmethod
    def _pair_term(y, m, x, act):
        return _PairTerm(y.data_ptr(), m.data_ptr(), x.data_ptr(),
                         act.data_ptr(), None, y.shape[0], x.shape[0], 0)

    def _parts(self, lib, B: int):
        """For B decoys: the sizes of the work buffer's parts (sums, each
        term's deriv, the kernel's partials) and the counters it needs."""
        layout = self._layout.get(B)
        if layout is None:
            counters = ctypes.c_longlong()
            size = getattr(lib, f"trx2dy_spline_{self.kind}_buffer")
            n = size(self._launch_constants(lib), len(self.terms), B,
                     self.device.index, ctypes.byref(counters))
            if n < 0:
                raise ValueError(f"{self.entry}: B={B} out of range")
            parts = [len(self.terms) * B] + [P * B for P in self.sizes]
            parts.append(n - sum(parts))
            layout = self._layout[B] = (parts, counters.value)
        return layout


class SplineLanes(SplinePairs):
    """The stage constants of the lanes entry: per term (tab, row, x, act),
    an interval table tab (P, U, K-1, 4), its lane -> row map row (C,)
    int32 and act (P, C), checked once when built (compact.union_stage
    builds one per protocol stage of a sampler step). Its queries must
    have C lanes."""

    entry = "spline_energy_lanes"
    kind = "lanes"

    def __init__(self, terms):
        super().__init__(terms)
        self.n_lanes = self.terms[0][1].shape[0]

    def _batch(self, qs) -> int:
        return self.n_lanes

    @staticmethod
    def _pair_term(tab, row, x, act):
        return _PairTerm(tab.data_ptr(), None, x.data_ptr(), act.data_ptr(),
                         row.data_ptr(), tab.shape[0], x.shape[0],
                         tab.shape[1])


class SplineDense(SplinePairs):
    """The stage constants of the dense entry: per term (y, m, x, mask),
    shared tables y, m (L, L, K_t), knots x (K_t,) and mask (L, L) bool,
    checked once when built (restraints.dense_splines builds one per stage
    of the single-program fold). Its queries are (B, L, L)."""

    entry = "spline_energy_dense"
    kind = "dense"

    def __init__(self, terms):
        super().__init__(terms)
        self.L = self.terms[0][3].shape[0]
        self.sizes = (self.L * self.L,) * len(self.terms)

    @staticmethod
    def _pair_term(y, m, x, mask):
        return _PairTerm(y.data_ptr(), m.data_ptr(), x.data_ptr(),
                         mask.data_ptr(), None, mask.numel(), x.shape[0], 0)

    def _batch(self, qs) -> int:
        return qs[0].shape[0] if qs[0].dim() == 3 else -1

    def _query_shape(self, P: int, B: int) -> tuple:
        return (B, self.L, self.L)


_counters: dict = {}    # device index -> the launches' counters


def _counter(dev, n: int) -> torch.Tensor:
    """At least n zeroed counters on dev, kept for every later launch (each
    launch leaves them at 0 again)."""
    c = _counters.get(dev.index)
    if c is None or c.numel() < n:
        c = _counters[dev.index] = torch.zeros(max(n, 1024),
                                               dtype=torch.int32, device=dev)
    return c


def _check_queries(tables: SplinePairs, qs) -> int:
    """The per-evaluation checks of the dense, pair and lanes entries;
    returns B (the lanes entry's C)."""
    entry = tables.entry
    if len(qs) != len(tables.terms):
        raise ValueError(f"{entry}: {len(qs)} query tensors for "
                         f"{len(tables.terms)} terms")
    B = tables._batch(qs)
    for n, (q, P) in enumerate(zip(qs, tables.sizes)):
        if q.device.type != "cuda":
            raise ValueError(f"{entry}: tensors must be on a CUDA device, "
                             f"got {q.device}")
        if q.device != tables.device or q.dtype != torch.float32:
            raise ValueError(f"{entry}: q[{n}] must be float32 on "
                             f"{tables.device}, got {q.dtype} on "
                             f"{q.device}")
        shape = tables._query_shape(P, B)
        if B < 1 or q.shape != shape or not q.is_contiguous():
            raise ValueError(f"{entry}: q[{n}] must be a contiguous "
                             f"{shape}, got {tuple(q.shape)}")
    return B


def _fused_launch(tables: SplinePairs, qs):
    """One launch of the dense, pair or lanes entry on CUDA tensors: (sums
    (n_terms, B), each term's deriv in its query's shape)."""
    B = _check_queries(tables, qs)
    lib = _lib()
    parts, n_counters = tables._parts(lib, B)
    dev = tables.device
    buf = torch.empty(sum(parts), dtype=torch.float32, device=dev)
    qptrs = tables._qptrs
    for n, q in enumerate(qs):
        qptrs[n] = q.data_ptr()
    launch = getattr(lib, f"trx2dy_spline_{tables.kind}")
    err = launch(tables._c, len(qs), qptrs, B, buf.data_ptr(),
                 _counter(dev, n_counters).data_ptr(), dev.index,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{tables.entry} kernel launch failed: "
                           f"cudaError {err}")
    sums, *derivs = buf.split(parts)[:-1]
    return sums.view(len(qs), B), tuple(
        d.view(tables._query_shape(P, B))
        for d, P in zip(derivs, tables.sizes))


def _dense_fwd(tables: SplineDense, qs):
    """(sums (n_terms, B), each term's deriv (B, L, L)): one launch."""
    if qs[0].device.type == "cpu":
        return spline_dense_terms_plain(tables.terms, qs)
    out = _fused_launch(tables, qs)
    spline_energy_dense.launches += 1
    return out


def _pairs_fwd(tables: SplinePairs, qs):
    """(sums (n_terms, B), each term's deriv (P_t, B)): one launch."""
    if qs[0].device.type == "cpu":
        return spline_pairs_plain(tables.terms, qs)
    out = _fused_launch(tables, qs)
    spline_energy_pairs.launches += 1
    return out


def _lanes_fwd(tables: SplineLanes, qs):
    """(sums (n_terms, C), each term's deriv (P_t, C)): one launch."""
    if qs[0].device.type == "cpu":
        return spline_lanes_plain(tables.terms, qs)
    out = _fused_launch(tables, qs)
    spline_energy_lanes.launches += 1
    return out


class _Dense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, *qs):
        sums, derivs = _dense_fwd(tables, qs)
        ctx.save_for_backward(*derivs)
        return sums

    @staticmethod
    def backward(ctx, g):
        return (None, *(gt[:, None, None] * d
                        for gt, d in zip(g.unbind(0), ctx.saved_tensors)))


class _Pairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, *qs):
        sums, derivs = _pairs_fwd(tables, qs)
        ctx.save_for_backward(*derivs)
        return sums

    @staticmethod
    def backward(ctx, g):
        return (None, *(gt * d for gt, d in zip(g.unbind(0),
                                                ctx.saved_tensors)))


class _Lanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, *qs):
        sums, derivs = _lanes_fwd(tables, qs)
        ctx.save_for_backward(*derivs)
        return sums

    @staticmethod
    def backward(ctx, g):
        return (None, *(gt * d for gt, d in zip(g.unbind(0),
                                                ctx.saved_tensors)))


def spline_energy_dense_terms(tables: SplineDense, qs) -> torch.Tensor:
    """(n_terms, B) masked spline energies of the queries qs (one
    (B, L, L) tensor per term of `tables`) over shared tables, one launch
    for all terms; differentiable in every q."""
    return _Dense.apply(tables, *qs)


def spline_energy_dense(y, m, x, q, mask):
    """(B,) masked spline energies of q (B, L, L) over shared (L, L, K)
    tables: the dense entry with one term; differentiable in q."""
    return spline_energy_dense_terms(SplineDense([(y, m, x, mask)]), [q])[0]


def spline_energy_pairs(tables: SplinePairs, qs) -> torch.Tensor:
    """(n_terms, B) masked spline energies of the pair-major queries qs
    (one (P_t, B) tensor per term of `tables`), one launch for all terms;
    differentiable in every q."""
    return _Pairs.apply(tables, *qs)


def spline_energy_lanes(tables: SplineLanes, qs) -> torch.Tensor:
    """(n_terms, C) masked spline energies of the pair-major queries qs
    (one (P_t, C) tensor per term of `tables`) over per-lane tables, one
    launch for all terms; differentiable in every q."""
    return _Lanes.apply(tables, *qs)


spline_energy_dense.launches = 0
spline_energy_pairs.launches = 0
spline_energy_lanes.launches = 0

"""Restraint tables of the Dynamics sampler, compiled on the device.

Port of trx2dy/physics/tablegen.py. Each sampler step rebuilds the
restraint tables of every lane from its dampened histograms, as array
work on the device with no host round trip:

  lane-stacked histograms (U, L, L, nbins)
    -> activation probabilities and per-family masks     (elementwise)
    -> one shared union pair list per term               (static size P)
    -> per-lane -log-ratio tables at the listed pairs    (gather)
    -> natural-cubic second derivatives                  (one product)
    -> disulfide harmonic wells                          (override)

giving compact.UnionRestraints and per-stage compact.UnionActs for the
folder (folder.fold_chains_pool). Per pair the formulas are those of
restraints.compile_restraints / restraint_masks and the disulfide rules;
only the iteration space (listed pairs, not dense (L, L)) differs.

Layout: tables are built only for the pool rows the fold's lanes use (a
few lanes fold from each histogram) and stored once per such row as
pair-major interval tables (P, U', K-1, 4), with a (C,) lane -> row map;
the activity is per lane, (P, C), the layout of the queries the union
energy computes. That is the storage the spline kernel's lanes entry
reads, so no evaluation transposes or expands anything.

The pair list of a term is JAX's jnp.nonzero(size=P, fill_value=1): the
union's flat indices in row-major order, padded to the static P with flat
index 1, the pair (0, 1). It is built by a cumulative sum and a scatter,
not torch.nonzero, which reads the count back to the host: the only host
reads of a sampler step are the 4 counts (count), the energies for the
candidate pick, the convergence deltas and the decoys.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from trx2dy_torch.dynamics.dampen import gaussian_smooth_bins
from trx2dy_torch.ops.spline_energy import interval_tables
from trx2dy_torch.physics.compact import (
    UnionActs, UnionRestraints, UnionTerm, rows_on_device,
)
from trx2dy_torch.physics.restraints import (
    FoldParams, dist_knots, planar_knots, torsion_knots,
)
from trx2dy_torch.physics.spline import _second_derivative_operator

# term -> (probability cutoff offset, triangle kind), restraint_masks'
# semantics (utils_ros.py:706-743: omega and theta need pcut + 0.5, phi
# pcut + 0.6; dist and omega act on the upper triangle, theta and phi on
# every off-diagonal pair)
_TERMS = (("dist", 0.0, "upper"), ("omega", 0.5, "upper"),
          ("theta", 0.5, "offdiag"), ("phi", 0.6, "offdiag"))
NAMES = tuple(name for name, _, _ in _TERMS)

# the disulfide gate (restraints.disulfide_pairs defaults) and well
# (add_disulfide_restraints)
_SS_GATE = 4.75
_SS_MIN_CONTACT = 0.5
_SS_MIN_SEP = 3
_SS_K = 10.0
_SS_D0 = 3.85


def _stage_ranges(mode: int, L: int):
    """Cumulative sequence-separation ranges of the centroid stages
    (folder._stage_masks_centroid, modes 0-2)."""
    if mode == 0:
        ranges = [(1, 12), (12, 24), (24, L)]
    elif mode == 1:
        ranges = [(3, 24), (24, L)]
    elif mode == 2:
        ranges = [(1, L)]
    else:
        raise ValueError(
            f"mode {mode} not supported by the device table compiler "
            "(0/1/2; mode 3 and idr targets need the host chain fold)")
    cum = []
    lo = ranges[0][0]
    for (s1, s2) in ranges:
        lo = min(lo, s1)
        cum.append((lo, s2))      # cumulative union of separation windows
    return cum


def _dampen_proxy(p: torch.Tensor) -> torch.Tensor:
    """One worst-case dampening step (the modal bin of every dampenable
    pair decayed by the default rate, renormalised, smoothed,
    renormalised), used only to size the chain steps' pair buckets; the
    masks always come from the real histograms."""
    nb = p.shape[-1]
    masked = torch.amax(p, dim=-1) < 0.5
    oh = torch.nn.functional.one_hot(torch.argmax(p, dim=-1), nb).bool()
    dec = torch.where(oh & masked[..., None], p * 0.5, p)
    ssum = torch.sum(dec, dim=-1, keepdim=True)
    dec = dec / torch.where(ssum == 0, 1.0, ssum)
    sm = gaussian_smooth_bins(dec, 1.0)
    ssum = torch.sum(sm, dim=-1, keepdim=True)
    sm = sm / torch.where(ssum == 0, 1.0, ssum)
    return torch.where(masked[..., None], sm, p)


def _nonzero_padded(mask: torch.Tensor, P: int) -> torch.Tensor:
    """jnp.nonzero(mask, size=P, fill_value=1): the True flat indices of a
    1-D mask in order, then 1s up to P, made with no host read. The caller
    guarantees at most P True entries."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, dim=0) - 1
    dst = torch.where(mask, pos, P)       # everything else to a spare slot
    out = torch.ones(P + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, dst, torch.arange(n, dtype=torch.int64,
                                      device=mask.device))
    return out[:P]


class UnionCompiler:
    """The (count, compile) pair of one static folding context: sequence,
    parameters, mode, cutoff, orientation and disulfide switches, device.
    The sequence-derived pair masks and the spline operators are device
    constants, made once per context (union_compiler caches it)."""

    def __init__(self, seq: str, params: FoldParams, mode: int, pcut: float,
                 use_orient: bool, detect_disulf: bool, device):
        p = self.params = params
        dev = torch.device(device)
        L = self.L = len(seq)
        self.use_orient = use_orient
        idx = np.arange(L)
        sep = np.abs(idx[:, None] - idx[None, :])
        upper = idx[:, None] < idx[None, :]
        offdiag = idx[:, None] != idx[None, :]
        tri = {"upper": upper, "offdiag": offdiag}
        isg = np.frombuffer(seq.encode(), np.uint8) == ord("G")
        nogly = ~(isg[:, None] | isg[None, :])
        ranges = _stage_ranges(mode, L)
        self.n_stages = len(ranges)
        range_masks = [(sep >= s1) & (sep < s2) for (s1, s2) in ranges]
        # families: the centroid stages, then relax round 1 (0.15) and
        # round 2 (0.30) with nogly (fold_chains' restraint_masks calls)
        fam_base = [(pcut, rm, False) for rm in range_masks]
        fam_base += [(0.15, sep >= 1, True), (0.30, sep >= 1, True)]
        # the union must cover every family's active set: the lowest
        # cutoff, the full separation range, no glycine filter
        self.union_cut = min(pcut, 0.15)

        is_c = np.frombuffer(seq.encode(), np.uint8) == ord("C")
        self.ss_possible = detect_disulf and is_c.sum() >= 2

        def on(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        self.ss_scope = on((is_c[:, None] & is_c[None, :])
                           & (sep >= _SS_MIN_SEP))
        knots = {"dist": dist_knots(p), "omega": torsion_knots(p),
                 "theta": torsion_knots(p), "phi": planar_knots(p)}
        self.knots = {k: on(v, torch.float32) for k, v in knots.items()}
        # (K, K) operators y -> m, float32 as in JAX; applied as y @ op.T
        self.ops_t = {k: on(_second_derivative_operator(
            np.asarray(v, np.float64)).astype(np.float32).T)
            for k, v in knots.items()}
        self.bkgr = on(((knots["dist"][3:] / p.DCUT) ** p.ALPHA)
                       .astype(np.float32))
        self.erep = on(np.asarray(p.EREP, np.float32))
        self.ss_well = on((_SS_K * (knots["dist"] - _SS_D0) ** 2)
                          .astype(np.float32))
        self.base = {}      # term -> (L, L) the pairs it may ever act on
        self.fam_ok = {}    # term -> [(cutoff, (L, L) family mask)]
        for name, off, kind in _TERMS:
            self.base[name] = on(tri[kind] & (sep >= 1))
            self.fam_ok[name] = [
                (cut + off, on(rmask & tri[kind] & (nogly if ng else True)))
                for cut, rmask, ng in fam_base]
        self.offsets = {name: off for name, off, _ in _TERMS}

    def probs_and_ss(self, pool: dict):
        """(U, L, L) activation probabilities per term and the per-lane
        disulfide pair mask (symmetric)."""
        pr = {"dist": torch.sum(pool["dist"][..., 5:], dim=-1)}
        if self.use_orient:
            for k in ("omega", "theta", "phi"):
                pr[k] = torch.sum(pool[k][..., 1:], dim=-1)
        else:
            neg = torch.full_like(pr["dist"], -1.0)
            pr.update(omega=neg, theta=neg, phi=neg)
        if self.ss_possible:
            d = pool["dist"]
            mode_d = 2.25 + 0.5 * torch.argmax(d[..., 1:], dim=-1)
            contact = torch.sum(d[..., 1:], dim=-1)
            ss = (self.ss_scope & (mode_d <= _SS_GATE)
                  & (contact >= _SS_MIN_CONTACT))
            ss = ss | ss.transpose(-1, -2)
        else:
            ss = torch.zeros(pr["dist"].shape, dtype=torch.bool,
                             device=pr["dist"].device)
        # disulfide pairs are active at every cutoff
        # (add_disulfide_restraints sets dist_prob = 1)
        pr["dist"] = torch.where(ss, 1.0, pr["dist"])
        return pr, ss

    def count(self, pool: dict) -> torch.Tensor:
        """(2, 4) int64 union-over-lanes active-pair counts per term (dist,
        omega, theta, phi), on the device: row 0 for the histograms as
        given (sizes the initial fold), row 1 for their union with a
        one-step dampening proxy (sizes the chain steps, so activation
        growth under dampening does not change the step's shapes)."""
        pr, _ = self.probs_and_ss(pool)
        keys = pool if self.use_orient else ("dist",)
        pr_d, _ = self.probs_and_ss(
            {**pool, **{k: _dampen_proxy(pool[k]) for k in keys}})
        raw, grown = [], []
        for name in NAMES:
            cut = self.union_cut + self.offsets[name]
            m = torch.any(pr[name] >= cut, dim=0) & self.base[name]
            md = m | (torch.any(pr_d[name] >= cut, dim=0) & self.base[name])
            raw.append(m.sum())
            grown.append(md.sum())
        return torch.stack([torch.stack(raw), torch.stack(grown)])

    def _tables_at_pairs(self, pool, name, flat, rows):
        """(P, U', K) -log-ratio spline values of the pool rows `rows` at
        the listed pairs: compile_restraints' formulas
        (restraints.py:99-150) at the union pair list only, pair-major."""
        p = self.params
        U, L = pool[name].shape[0], self.L
        nb = pool[name].shape[-1]
        ph = pool[name].reshape(U, L * L, nb).index_select(1, flat) \
            .index_select(0, rows)
        ph = ph.transpose(0, 1)                           # (P, U, nb)
        if name == "dist":
            attr = (-torch.log((ph[..., 5:] + p.MEFF)
                               / (ph[..., -1:] * self.bkgr + 1e-6)) + p.EBASE)
            repul = torch.clamp_min(attr[..., :1], 0.0) + self.erep
            return torch.cat([repul, attr], dim=-1)
        y = -torch.log((ph + p.MEFF) / (ph[..., -1:] + p.MEFF))
        if name == "phi":
            return torch.cat([torch.flip(y[..., 1:3], [-1]), y[..., 1:],
                              torch.flip(y[..., -2:], [-1])], dim=-1)
        return torch.cat([y[..., -2:], y[..., 1:], y[..., 1:3]], dim=-1)

    def compile(self, pool: dict, lane_map, P: tuple):
        """pool: per-term (U, L, L, nbins) lane-stacked histograms;
        lane_map: (C,) fold lane -> pool row; P: per-term pair-list sizes
        (dist, omega, theta, phi), each at least the term's count.

        Returns (UnionRestraints with (P, U', K-1, 4) tables of the U'
        distinct pool rows in lane_map and a (C,) lane -> row map, [UnionActs
        of each centroid stage], relax round-1 acts, relax round-2 acts),
        acts (P, C) bool. The rows come from the host-side lane_map, so
        nothing is read back."""
        L = self.L
        dev = pool["dist"].device
        lane_np = np.asarray(lane_map, np.int64)
        used, inverse = np.unique(lane_np, return_inverse=True)
        if used[0] < 0 or used[-1] >= pool["dist"].shape[0]:
            raise ValueError(f"lane_map rows {used[0]}..{used[-1]} outside "
                             f"the pool's {pool['dist'].shape[0]}")
        rows = torch.as_tensor(used, device=dev)
        row = torch.as_tensor(inverse.reshape(-1), dtype=torch.int32,
                              device=dev)
        lane_map = torch.as_tensor(lane_np, device=dev)
        pr, ss = self.probs_and_ss(pool)
        terms = {}
        acts = {name: [] for name in NAMES}
        for name, P_t in zip(NAMES, P):
            base = self.base[name]
            union = torch.any(pr[name] >= self.union_cut + self.offsets[name],
                              dim=0) & base
            if name == "dist" and self.ss_possible:
                union = union | (torch.any(ss, dim=0) & base)
            flat = _nonzero_padded(union.reshape(-1), P_t)
            pad = torch.arange(P_t, device=dev) >= union.sum()
            i, j = flat // L, flat % L

            y_u = self._tables_at_pairs(pool, name, flat, rows)  # (P, U', K)
            U = pr[name].shape[0]
            if name == "dist" and self.ss_possible:
                ss_pair = ss.reshape(U, L * L).index_select(1, flat) \
                    .index_select(0, rows).T
                y_u = torch.where(ss_pair[..., None], self.ss_well, y_u)
            if not self.use_orient and name != "dist":
                y_u = torch.zeros_like(y_u)
            m_u = y_u @ self.ops_t[name]
            terms[name] = UnionTerm(
                i=rows_on_device(i, L), j=rows_on_device(j, L),
                tab=interval_tables(y_u, m_u), row=row, x=self.knots[name])

            prob_pair = pr[name].reshape(U, L * L).index_select(1, flat)
            prob_pair = prob_pair.T.index_select(1, lane_map)   # (P, C)
            for cut, fam in self.fam_ok[name]:
                ok = fam.reshape(-1).index_select(0, flat)      # (P,)
                acts[name].append((prob_pair >= cut)
                                  & (ok & ~pad)[:, None])

        ur = UnionRestraints(**terms)
        fams = [UnionActs(*(acts[name][f] for name in NAMES))
                for f in range(self.n_stages + 2)]
        return (ur, fams[:self.n_stages], fams[self.n_stages],
                fams[self.n_stages + 1])


@functools.lru_cache(maxsize=16)
def _compiler_cache(seq, params, mode, pcut, use_orient, detect_disulf,
                    device) -> UnionCompiler:
    return UnionCompiler(seq, params, mode, pcut, use_orient, detect_disulf,
                         device)


def union_compiler(seq: str, params: FoldParams = FoldParams(),
                   mode: int = 2, pcut: float | None = None,
                   use_orient: bool = True, detect_disulf: bool = True,
                   device="cpu") -> UnionCompiler:
    """The table compiler of a static folding context on `device`, cached
    per (seq, params, mode, pcut, use_orient, detect_disulf, device)."""
    pcut = params.PCUT if pcut is None else pcut
    return _compiler_cache(seq, params, mode, float(pcut), use_orient,
                           detect_disulf, str(torch.device(device)))

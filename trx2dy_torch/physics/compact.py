"""Compacted active-pair restraint evaluation.

Port of trx2dy/physics/compact.py for the shared-table fold and the
Dynamics sampler's union form. A stage's activation masks are constants,
so they are compacted on the host into per-term pair lists (i, j) with
their gathered spline tables, padded to a half-octave bucket (the JAX
ladder, so shapes match and stay few). Geometry is computed per active
pair from gathered atoms, and the four terms' splines run through the
kernel's pair entry (ops.spline_energy_pairs) in one launch per energy
evaluation; compact_to checks the stage's tables for it once.

The sampler's union form (UnionRestraints, built on the device by
physics/tablegen.py) shares one pair list per term among all lanes, with a
table and an activity per lane, laid out pair-major: the tables are stored
once per pool row the lanes fold from, as interval tables tab (P, U, K-1,
4) behind a lane -> row map row (C,), and acts are (P, C). Its splines run
through the kernel's lanes entry (ops.spline_energy_lanes), one launch per
evaluation; union_stage checks a protocol stage's tables for it once per
sampler step. The host chain fold (folder.fold_chains) takes the same
form, built on the host from per-lane restraint sets by
compact_restraints_lanes, one pair list per protocol stage.

Atoms are gathered by index: JAX's one-hot product at Precision.HIGHEST
(compact.py:427-431) is an exact gather chosen for the TPU's matrix unit,
and an index gather gives the same values with no product that TF32 could
touch. The gather's backward is a fixed-order segment sum over the pairs
sorted by residue, not index_add_, whose atomics on the GPU would make a
fold's trajectory differ from run to run.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from trx2dy_torch.geometry.transforms import bond_angle, dihedral
from trx2dy_torch.ops.spline_energy import (
    SplineLanes, SplinePairs, interval_tables, spline_energy_lanes,
    spline_energy_pairs,
)
from trx2dy_torch.physics.restraints import RestraintMasks, RestraintSet
from trx2dy_torch.physics.spline import masked_spline_energy

PAIR_BUCKET = 512   # smallest pair-list bucket; buckets grow in half-octave
#                     steps (512, 768, 1024, 1536, 2048, ...)


class CompactTerm(NamedTuple):
    """Active pairs of one restraint term, padded to a bucket size."""
    i: object     # (P,) residue index i; Rows on the device (compact_to)
    j: object     # (P,) residue index j; Rows on the device
    y: object     # (P, K) spline values at the shared knots
    m: object     # (P, K) spline second derivatives
    x: object     # (K,) shared knots
    act: object   # (P,) bool; False on bucket padding


class CompactRestraints(NamedTuple):
    dist: CompactTerm
    omega: CompactTerm
    theta: CompactTerm
    phi: CompactTerm
    splines: object = None   # SplinePairs of the four terms (compact_to)


class Rows(NamedTuple):
    """A residue index vector on the device, with what the deterministic
    backward of its gather needs."""
    idx: torch.Tensor       # (P,) int64 residue index
    order: torch.Tensor     # (P,) positions sorted by residue (stable)
    offsets: torch.Tensor   # (L + 1,) start of each residue's positions


def rows_on_device(idx: torch.Tensor, L: int) -> Rows:
    """Rows of a residue index tensor, made where it lies with no host
    read."""
    idx = idx.to(torch.int64)
    order = torch.argsort(idx, stable=True)
    offsets = torch.searchsorted(
        idx[order], torch.arange(L + 1, dtype=torch.int64, device=idx.device))
    return Rows(idx, order, offsets)


def _rows(idx: np.ndarray, L: int, device) -> Rows:
    return rows_on_device(torch.as_tensor(np.asarray(idx), device=device), L)


class _GatherRows(torch.autograd.Function):
    """a.index_select(0, rows.idx), with each row's cotangents summed in a
    fixed order."""

    @staticmethod
    def forward(ctx, a, rows):
        ctx.rows = rows
        return a.index_select(0, rows.idx)

    @staticmethod
    def backward(ctx, g):
        r = ctx.rows
        return torch.segment_reduce(g.index_select(0, r.order), "sum",
                                    offsets=r.offsets, axis=0,
                                    unsafe=True), None


def gather_rows(a: torch.Tensor, rows: Rows) -> torch.Tensor:
    """Rows of a (L, ...) at rows.idx, deterministic in value and gradient."""
    return _GatherRows.apply(a, rows)


def _bucket(n: int) -> int:
    b = PAIR_BUCKET
    while b < n:
        b = b * 3 // 2 if b & (b - 1) == 0 else (b // 3) * 4
    return b


def _compact_term(table, mask) -> CompactTerm:
    """Host numpy in, numpy out. Padding pairs are (0, 1), distinct
    residues, so every padded query is finite; act=False zeroes their
    energy and derivative."""
    mask_np = np.asarray(mask)
    L = mask_np.shape[0]
    ii, jj = np.nonzero(mask_np)
    P = _bucket(len(ii))
    pad = P - len(ii)
    i = np.concatenate([ii, np.zeros(pad, np.int64)]).astype(np.int32)
    j = np.concatenate([jj, np.full(pad, min(1, L - 1), np.int64)]
                       ).astype(np.int32)
    act = np.concatenate([np.ones(len(ii), bool), np.zeros(pad, bool)])
    flat = i.astype(np.int64) * L + j
    K = table.y.shape[-1]
    y = np.asarray(table.y).reshape(L * L, K)[flat]
    m = np.asarray(table.m).reshape(L * L, K)[flat]
    return CompactTerm(i, j, y, m, np.asarray(table.x), act)


def compact_restraints(rst: RestraintSet,
                       masks: RestraintMasks) -> CompactRestraints:
    """One stage's masks as padded pair lists (host numpy)."""
    return CompactRestraints(
        dist=_compact_term(rst.dist, masks.dist),
        omega=_compact_term(rst.omega, masks.omega),
        theta=_compact_term(rst.theta, masks.theta),
        phi=_compact_term(rst.phi, masks.phi),
    )


def compact_to(cr: CompactRestraints, L: int, device,
               dtype=torch.float32) -> CompactRestraints:
    """The pair lists of an L-residue target as tensors on `device`: i, j
    as Rows, tables and knots of `dtype`, bool activity (one transfer per
    stage), and their SplinePairs for the kernel's pair entry. A table the
    entry does not take (K > 64, a dtype other than float32 on the card, a
    non-contiguous array) raises ValueError here, once per stage."""
    def term(t):
        return CompactTerm(
            i=_rows(t.i, L, device), j=_rows(t.j, L, device),
            y=torch.as_tensor(t.y, dtype=dtype, device=device),
            m=torch.as_tensor(t.m, dtype=dtype, device=device),
            x=torch.as_tensor(t.x, dtype=dtype, device=device),
            act=torch.as_tensor(t.act, dtype=torch.bool, device=device))
    terms = [term(t) for t in (cr.dist, cr.omega, cr.theta, cr.phi)]
    return CompactRestraints(*terms, splines=SplinePairs(
        (t.y, t.m, t.x, t.act) for t in terms))


def compact_restraint_energy(atoms: dict, cr: CompactRestraints,
                             w_atom_pair, w_dihedral, w_angle,
                             dist_on_ca: bool = False) -> torch.Tensor:
    """Restraint energy of one decoy (atoms (L, 3)) over device pair lists
    (compact_to), with the plain masked spline energy."""
    n, ca, cb = atoms["N"], atoms["CA"], atoms["CB"]
    g = gather_rows

    t = cr.dist
    base = ca if dist_on_ca else cb
    dvec = g(base, t.i) - g(base, t.j)
    q = torch.sqrt(torch.sum(dvec * dvec, dim=-1) + 1e-12)
    e = w_atom_pair * masked_spline_energy(t.y, t.m, t.x, q, t.act)
    t = cr.omega
    q = dihedral(g(ca, t.i), g(cb, t.i), g(cb, t.j), g(ca, t.j))
    e = e + w_dihedral * masked_spline_energy(t.y, t.m, t.x, q, t.act)
    t = cr.theta
    q = dihedral(g(n, t.i), g(ca, t.i), g(cb, t.i), g(cb, t.j))
    e = e + w_dihedral * masked_spline_energy(t.y, t.m, t.x, q, t.act)
    t = cr.phi
    q = bond_angle(g(ca, t.i), g(cb, t.i), g(cb, t.j))
    return e + w_angle * masked_spline_energy(t.y, t.m, t.x, q, t.act)


def _pair_queries(atoms_b: dict, terms, dist_on_ca: bool = False):
    """The four terms' pair-major (P_t, B) queries of a decoy batch (atoms
    (B, L, 3)) at the terms' device pair lists (i, j as Rows)."""
    # (L, B, 9): per residue row, all decoys' N | CA | CB
    A = torch.cat([atoms_b["N"], atoms_b["CA"], atoms_b["CB"]], dim=-1)
    A = A.transpose(0, 1).contiguous()

    def side(rows):
        picked = gather_rows(A, rows).unflatten(-1, (3, 3))  # (P, B, 3, 3)
        return picked[..., 0, :], picked[..., 1, :], picked[..., 2, :]

    dist, omega, theta, phi = terms
    _, ca_i, cb_i = side(dist.i)
    _, ca_j, cb_j = side(dist.j)
    dvec = (ca_i - ca_j) if dist_on_ca else (cb_i - cb_j)
    q_dist = torch.sqrt(torch.sum(dvec * dvec, dim=-1) + 1e-12)
    _, ca_i, cb_i = side(omega.i)
    _, ca_j, cb_j = side(omega.j)
    q_omega = dihedral(ca_i, cb_i, cb_j, ca_j)
    n_i, ca_i, cb_i = side(theta.i)
    _, _, cb_j = side(theta.j)
    q_theta = dihedral(n_i, ca_i, cb_i, cb_j)
    _, ca_i, cb_i = side(phi.i)
    _, _, cb_j = side(phi.j)
    q_phi = bond_angle(ca_i, cb_i, cb_j)
    return [q.contiguous() for q in (q_dist, q_omega, q_theta, q_phi)]


def compact_restraint_energy_batch(atoms_b: dict, cr: CompactRestraints,
                                   w_atom_pair, w_dihedral, w_angle,
                                   dist_on_ca: bool = False) -> torch.Tensor:
    """Restraint energy of a decoy batch (atoms (B, L, 3)) over device pair
    lists (compact_to), pair-major: (B,) energies. The four terms' queries
    go to the spline kernel in one launch; the weights stay outside it."""
    qs = _pair_queries(atoms_b, (cr.dist, cr.omega, cr.theta, cr.phi),
                       dist_on_ca)
    e_dist, e_omega, e_theta, e_phi = spline_energy_pairs(cr.splines,
                                                          qs).unbind(0)
    return w_atom_pair * e_dist + w_dihedral * e_omega + \
        w_dihedral * e_theta + w_angle * e_phi


class UnionTerm(NamedTuple):
    """One restraint term of the sampler: a pair list shared by every lane
    (the union of the lanes' active pairs) with a table per lane, stored
    once per used pool row (compact.py:294-325 holds y, m lane-major per
    lane as (C, P, K); ops.spline_energy.expand_lane_tables gives that
    back)."""
    i: Rows               # (P,) residue index i, shared across lanes
    j: Rows               # (P,) residue index j
    tab: torch.Tensor     # (P, U, K-1, 4) interval tables of the U rows
    row: torch.Tensor     # (C,) int32 lane -> table row
    x: torch.Tensor       # (K,) shared knots


class UnionRestraints(NamedTuple):
    dist: UnionTerm
    omega: UnionTerm
    theta: UnionTerm
    phi: UnionTerm


class UnionActs(NamedTuple):
    """Per-lane activity on the shared pair lists for one protocol stage,
    each (P, C) bool."""
    dist: torch.Tensor
    omega: torch.Tensor
    theta: torch.Tensor
    phi: torch.Tensor


class UnionStage(NamedTuple):
    """A protocol stage of the sampler's fold: the tables, the stage's
    activity, and their SplineLanes for the kernel's lanes entry."""
    ur: UnionRestraints
    acts: UnionActs
    splines: SplineLanes


def union_stage(ur: UnionRestraints, acts: UnionActs) -> UnionStage:
    """The stage with its SplineLanes, which checks the tables (once per
    stage of a sampler step, not per evaluation)."""
    return UnionStage(ur, acts, SplineLanes(
        (t.tab, t.row, t.x, a) for t, a in zip(ur, acts)))


def union_take_lanes(ur: UnionRestraints, acts: UnionActs, sel):
    """The surviving lanes sel of the tables and activity (the folder's
    converged-lane repacking): only the lane -> row map and act carry the
    lane axis; the tables, pair lists and knots are shared."""
    sel = torch.as_tensor(sel, dtype=torch.int64, device=ur.dist.row.device)
    terms = [t._replace(row=t.row.index_select(0, sel)) for t in ur]
    return (UnionRestraints(*terms),
            UnionActs(*[a.index_select(1, sel) for a in acts]))


def compact_restraints_lanes(rsts, masks_list, floor: dict | None = None,
                             device="cpu",
                             dtype=torch.float32) -> UnionStage:
    """One protocol stage of the host chain fold (folder.fold_chains): lane
    k folds against its own restraint set rsts[k] under its own masks
    masks_list[k] (host numpy, compact.py:141-150).

    JAX stacks per-lane pair lists, lane-major (M, P, K). The port builds
    the sampler's union form on the host instead, so the stage runs
    through the kernel's lanes entry: per term one pair list, the union of
    the lanes' active pairs padded to a half-octave bucket of at least
    floor[term]; interval tables of the distinct (table, mask) objects
    only, as JAX dedups them (fold_chains fans one object out to every
    lane of an npz); a lane -> row map; each lane's activity on the union.
    A lane's energy is JAX's up to summation order. Returns the
    UnionStage on `device`, its tables of `dtype`."""
    L = np.asarray(masks_list[0].dist).shape[0]
    terms, acts = [], []
    for name in ("dist", "omega", "theta", "phi"):
        memo: dict = {}
        lane_row = []
        for rst, masks in zip(rsts, masks_list):
            key = (id(getattr(rst, name)), id(getattr(masks, name)))
            if key not in memo:
                memo[key] = (len(memo), getattr(rst, name),
                             np.asarray(getattr(masks, name)))
            lane_row.append(memo[key][0])
        rows = list(memo.values())
        ii, jj = np.nonzero(np.any([m for _, _, m in rows], axis=0))
        n = len(ii)
        P = max(_bucket(n), (floor or {}).get(name, 0))
        i = np.concatenate([ii, np.zeros(P - n, np.int64)])
        j = np.concatenate([jj, np.full(P - n, min(1, L - 1), np.int64)])
        flat = i * L + j
        K = rows[0][1].y.shape[-1]

        def at_pairs(a):       # (P, U', K) of each row's (L, L, K) table
            return torch.as_tensor(np.stack(
                [np.asarray(a(t)).reshape(L * L, K)[flat]
                 for _, t, _ in rows], axis=1), dtype=dtype, device=device)

        act_u = np.stack([m.reshape(L * L)[flat] for _, _, m in rows])
        act_u[:, n:] = False                                   # padding
        terms.append(UnionTerm(
            i=_rows(i, L, device), j=_rows(j, L, device),
            tab=interval_tables(at_pairs(lambda t: t.y),
                                at_pairs(lambda t: t.m)),
            row=torch.as_tensor(lane_row, dtype=torch.int32, device=device),
            x=torch.as_tensor(np.asarray(rows[0][1].x), dtype=dtype,
                              device=device)))
        acts.append(torch.as_tensor(np.ascontiguousarray(act_u[lane_row].T),
                                    device=device))
    return union_stage(UnionRestraints(*terms), UnionActs(*acts))


def compact_restraint_energy_union(atoms_b: dict, stage: UnionStage,
                                   w_atom_pair, w_dihedral, w_angle,
                                   dist_on_ca: bool = False) -> torch.Tensor:
    """Restraint energy of the sampler's lanes (atoms (C, L, 3)) over the
    shared pair lists with per-lane tables (compact.py:345-400): (C,)
    energies. Atom selection is the batch path's deterministic gather; the
    four terms' pair-major queries go to the kernel's lanes entry in one
    launch."""
    qs = _pair_queries(atoms_b, stage.ur, dist_on_ca)
    e_dist, e_omega, e_theta, e_phi = spline_energy_lanes(stage.splines,
                                                          qs).unbind(0)
    return w_atom_pair * e_dist + w_dihedral * e_omega + \
        w_dihedral * e_theta + w_angle * e_phi


# the host chain fold's lanes (compact.py:248-292) are a UnionStage from
# compact_restraints_lanes, evaluated as the sampler's
compact_restraint_energy_lanes = compact_restraint_energy_union

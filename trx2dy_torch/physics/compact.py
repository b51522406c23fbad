"""Compacted active-pair restraint evaluation.

Port of trx2dy/physics/compact.py for the shared-table fold. A stage's
activation masks are constants, so they are compacted on the host into
per-term pair lists (i, j) with their gathered spline tables, padded to a
half-octave bucket (the JAX ladder, so shapes match and stay few).
Geometry is computed per active pair from gathered atoms, and the splines
run through the kernel's pair entry (ops.spline_energy_pairs), one launch
per term.

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
from trx2dy_torch.ops.spline_energy import spline_energy_pairs
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


class Rows(NamedTuple):
    """A residue index vector on the device, with what the deterministic
    backward of its gather needs."""
    idx: torch.Tensor       # (P,) int64 residue index
    order: torch.Tensor     # (P,) positions sorted by residue (stable)
    offsets: torch.Tensor   # (L + 1,) start of each residue's positions


def _rows(idx: np.ndarray, L: int, device) -> Rows:
    counts = np.bincount(idx, minlength=L)
    return Rows(*(torch.as_tensor(a, dtype=torch.int64, device=device)
                  for a in (idx, np.argsort(idx, kind="stable"),
                            np.concatenate([[0], np.cumsum(counts)]))))


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
    as Rows, contiguous tables and knots of `dtype`, bool activity (one
    transfer per stage)."""
    def term(t):
        return CompactTerm(
            i=_rows(t.i, L, device), j=_rows(t.j, L, device),
            y=torch.as_tensor(t.y, dtype=dtype, device=device),
            m=torch.as_tensor(t.m, dtype=dtype, device=device),
            x=torch.as_tensor(t.x, dtype=dtype, device=device),
            act=torch.as_tensor(t.act, dtype=torch.bool, device=device))
    return CompactRestraints(*(term(t) for t in cr))


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


def compact_restraint_energy_batch(atoms_b: dict, cr: CompactRestraints,
                                   w_atom_pair, w_dihedral, w_angle,
                                   dist_on_ca: bool = False) -> torch.Tensor:
    """Restraint energy of a decoy batch (atoms (B, L, 3)) over device pair
    lists (compact_to), pair-major: (B,) energies."""
    # (L, B, 9): per residue row, all decoys' N | CA | CB
    A = torch.cat([atoms_b["N"], atoms_b["CA"], atoms_b["CB"]], dim=-1)
    A = A.transpose(0, 1).contiguous()

    def side(rows):
        picked = gather_rows(A, rows).unflatten(-1, (3, 3))  # (P, B, 3, 3)
        return picked[..., 0, :], picked[..., 1, :], picked[..., 2, :]

    def term(t, q):
        return spline_energy_pairs(t.y, t.m, t.x, q.contiguous(), t.act)

    t = cr.dist
    _, ca_i, cb_i = side(t.i)
    _, ca_j, cb_j = side(t.j)
    dvec = (ca_i - ca_j) if dist_on_ca else (cb_i - cb_j)
    e = w_atom_pair * term(t, torch.sqrt(torch.sum(dvec * dvec, dim=-1)
                                         + 1e-12))
    t = cr.omega
    _, ca_i, cb_i = side(t.i)
    _, ca_j, cb_j = side(t.j)
    e = e + w_dihedral * term(t, dihedral(ca_i, cb_i, cb_j, ca_j))
    t = cr.theta
    n_i, ca_i, cb_i = side(t.i)
    _, _, cb_j = side(t.j)
    e = e + w_dihedral * term(t, dihedral(n_i, ca_i, cb_i, cb_j))
    t = cr.phi
    _, ca_i, cb_i = side(t.i)
    _, _, cb_j = side(t.j)
    return e + w_angle * term(t, bond_angle(ca_i, cb_i, cb_j))

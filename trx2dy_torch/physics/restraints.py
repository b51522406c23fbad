"""Restraint compilation: predicted histograms -> dense spline energy tables.

Port of trx2dy/physics/restraints.py for rst_mode "no-idp" (reference
folding/utils_ros/utils_ros.py:6-146 gen_rst, add_rst :706-743). The tables
of all (L, L) pairs are compiled on the host in numpy, exactly as the JAX
package does, and fitted as natural cubic splines in one product:

  dist  knots [0, 2, 3.5] ++ [4.25 + 0.5 k, k=0..31]                  (35)
        attr_k = -log((p_k + MEFF) / (p_last (x_k/DCUT)^ALPHA + 1e-6)) + EBASE
        repul  = max(attr_0, 0) + EREP                          (3 knots)
  omega, theta  knots linspace(-pi-1.5A, pi+1.5A, 28),
        y = -log((p + MEFF)/(p_last + MEFF)); pad [y[-2:], y[1:], y[1:3]]
  phi   knots linspace(-1.5A, pi+1.5A, 16),
        pad [flip(y[1:3]), y[1:], flip(y[-2:])]

Selection (probability cutoffs, sequence separation, glycine exclusion) is
a set of boolean (L, L) host masks (restraint_masks). The af2, idp and gpcr
restraint modes come with a later slice of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from trx2dy_torch.physics.spline import (
    SplineTable, fit_natural_cubic, masked_spline_energy,
)


class FoldParams(NamedTuple):
    """Numeric parameters of folding/data/params.json (keys kept verbatim)."""
    PCUT: float = 0.05
    PCUT1: float = 0.5
    EBASE: float = -0.5
    EREP: tuple = (10.0, 3.0, 0.5)
    DREP: tuple = (0.0, 2.0, 3.5)
    PREP: float = 0.1
    SIGD: float = 10.0
    SIGM: float = 1.0
    MEFF: float = 1e-4
    DCUT: float = 19.5
    ALPHA: float = 1.57
    DSTEP: float = 0.5
    ASTEP: float = 15.0  # degrees


class RestraintSet(NamedTuple):
    """Dense spline tables and activation probabilities of one npz."""
    dist: SplineTable       # y/m: (L, L, 35)
    dist_prob: object       # (L, L) = sum(p[5:])
    omega: SplineTable      # (L, L, 28)
    omega_prob: object
    theta: SplineTable      # (L, L, 28)
    theta_prob: object
    phi: SplineTable        # (L, L, 16)
    phi_prob: object


class RestraintMasks(NamedTuple):
    """Active (L, L) boolean masks per geometry type for one stage."""
    dist: object
    omega: object
    theta: object
    phi: object


def dist_knots(p: FoldParams = FoldParams()) -> np.ndarray:
    return np.concatenate([np.asarray(p.DREP),
                           4.25 + p.DSTEP * np.arange(32)])


def torsion_knots(p: FoldParams = FoldParams()) -> np.ndarray:
    a = np.deg2rad(p.ASTEP)
    return np.linspace(-np.pi - 1.5 * a, np.pi + 1.5 * a, 28)


def planar_knots(p: FoldParams = FoldParams()) -> np.ndarray:
    a = np.deg2rad(p.ASTEP)
    return np.linspace(-1.5 * a, np.pi + 1.5 * a, 16)


def compile_restraints(npz: dict, params: FoldParams = FoldParams(),
                       use_orient: bool = True) -> RestraintSet:
    """Dense spline tables from a predicted-geometry npz dict (host numpy).

    npz: 'dist' (L, L, 37) and, with use_orient, 'omega'/'theta' (L, L, 25)
    and 'phi' (L, L, 13) softmaxed histograms. Without use_orient the angle
    tables are flat zeros with probability -1, so they never activate."""
    p = params
    dist = np.asarray(npz["dist"], dtype=np.float32)
    L = dist.shape[0]

    xk = dist_knots(p)
    bkgr = (xk[3:] / p.DCUT) ** p.ALPHA
    attr = (-np.log((dist[:, :, 5:] + p.MEFF)
                    / (dist[:, :, -1][:, :, None] * bkgr[None, None, :] + 1e-6))
            + p.EBASE)
    repul = np.maximum(attr[:, :, 0], 0.0)[:, :, None] + np.asarray(p.EREP)
    ydist = np.concatenate([repul, attr], axis=-1).astype(np.float32)
    dist_prob = dist[:, :, 5:].sum(-1)

    if use_orient:
        omega = np.asarray(npz["omega"], dtype=np.float32)
        theta = np.asarray(npz["theta"], dtype=np.float32)
        phi = np.asarray(npz["phi"], dtype=np.float32)

        def torsion_table(t):
            y = -np.log((t + p.MEFF) / (t[:, :, -1] + p.MEFF)[:, :, None])
            return np.concatenate(
                [y[:, :, -2:], y[:, :, 1:], y[:, :, 1:3]], axis=-1
            ).astype(np.float32)

        yomega = torsion_table(omega)
        ytheta = torsion_table(theta)
        yphi_raw = -np.log((phi + p.MEFF)
                           / (phi[:, :, -1] + p.MEFF)[:, :, None])
        yphi = np.concatenate(
            [np.flip(yphi_raw[:, :, 1:3], axis=-1), yphi_raw[:, :, 1:],
             np.flip(yphi_raw[:, :, -2:], axis=-1)], axis=-1
        ).astype(np.float32)
        omega_prob = omega[:, :, 1:].sum(-1)
        theta_prob = theta[:, :, 1:].sum(-1)
        phi_prob = phi[:, :, 1:].sum(-1)
    else:
        yomega = np.zeros((L, L, 28), np.float32)
        ytheta = np.zeros((L, L, 28), np.float32)
        yphi = np.zeros((L, L, 16), np.float32)
        omega_prob = theta_prob = phi_prob = np.full((L, L), -1.0, np.float32)

    return RestraintSet(
        dist=fit_natural_cubic(xk, ydist), dist_prob=dist_prob,
        omega=fit_natural_cubic(torsion_knots(p), yomega),
        omega_prob=omega_prob,
        theta=fit_natural_cubic(torsion_knots(p), ytheta),
        theta_prob=theta_prob,
        phi=fit_natural_cubic(planar_knots(p), yphi), phi_prob=phi_prob,
    )


def restraint_masks(rst: RestraintSet, seq: str, sep1: int, sep2: int,
                    pcut: float = 0.05, nogly: bool = False) -> RestraintMasks:
    """Host boolean activation masks (reference add_rst, utils_ros.py:
    706-743): sep1 <= |i-j| < sep2; prob >= pcut (+0.5 for omega/theta,
    +0.6 for phi); dist/omega upper triangle only; glycine pairs dropped
    with nogly."""
    L = rst.dist_prob.shape[0]
    idx = np.arange(L)
    sep = np.abs(idx[:, None] - idx[None, :])
    sep_ok = (sep >= sep1) & (sep < sep2)
    upper = idx[:, None] < idx[None, :]
    offdiag = idx[:, None] != idx[None, :]
    if nogly:
        isg = np.frombuffer(seq.encode(), dtype=np.uint8) == ord("G")
        sep_ok = sep_ok & ~(isg[:, None] | isg[None, :])
    return RestraintMasks(
        dist=sep_ok & upper & (np.asarray(rst.dist_prob) >= pcut),
        omega=sep_ok & upper & (np.asarray(rst.omega_prob) >= pcut + 0.5),
        theta=sep_ok & offdiag & (np.asarray(rst.theta_prob) >= pcut + 0.5),
        phi=sep_ok & offdiag & (np.asarray(rst.phi_prob) >= pcut + 0.6),
    )


def disulfide_pairs(dist_hist, seq: str, gate: float = 4.75,
                    min_contact: float = 0.5, min_sep: int = 3) -> np.ndarray:
    """(P, 2) candidate disulfide CYS pairs (i < j) from the predicted
    distance histogram: both CYS, |i-j| >= min_sep, mode CB-CB distance
    <= gate and contact probability >= min_contact (the '-detect_disulf'
    stand-in, folding/folding.py:48,233)."""
    p = np.asarray(dist_hist)
    L = p.shape[0]
    is_c = np.frombuffer(seq[:L].encode(), np.uint8) == ord("C")
    if is_c.sum() < 2:
        return np.zeros((0, 2), np.int64)
    # npz layout: bin 0 = no contact, bins 1..36 = [2, 20) A at 0.5 A
    mode_d = 2.25 + 0.5 * p[:, :, 1:].argmax(-1)
    contact = p[:, :, 1:].sum(-1)
    ii, jj = np.triu_indices(L, k=min_sep)
    ok = (is_c[ii] & is_c[jj] & (mode_d[ii, jj] <= gate)
          & (contact[ii, jj] >= min_contact))
    return np.stack([ii[ok], jj[ok]], axis=-1)


def add_disulfide_restraints(rst: RestraintSet, pairs: np.ndarray,
                             k_spring: float = 10.0,
                             d0: float = 3.85) -> RestraintSet:
    """Replace the dist spline of the given pairs with the harmonic well
    k_spring (d_CB-CB - d0)^2 and force them active at every cutoff
    (dist_prob = 1)."""
    if len(pairs) == 0:
        return rst
    x = np.asarray(rst.dist.x)
    y = np.array(np.asarray(rst.dist.y))
    well = (k_spring * (x - d0) ** 2).astype(y.dtype)
    prob = np.array(np.asarray(rst.dist_prob))
    for i, j in np.asarray(pairs):
        y[i, j] = y[j, i] = well
        prob[i, j] = prob[j, i] = 1.0
    return rst._replace(dist=fit_natural_cubic(x, y), dist_prob=prob)


def tables_to(rst: RestraintSet, device,
              dtype=torch.float32) -> RestraintSet:
    """The restraint set with every table and probability as a tensor on
    `device` (one transfer per fold)."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return RestraintSet(*(SplineTable(*(t(a) for a in v))
                          if isinstance(v, SplineTable) else t(v)
                          for v in rst))


def masks_to(masks: RestraintMasks, device) -> RestraintMasks:
    return RestraintMasks(*(torch.as_tensor(np.asarray(mk), device=device)
                            for mk in masks))


def restraint_energy(rst: RestraintSet, masks: RestraintMasks,
                     dist, omega, theta, phi,
                     w_atom_pair, w_dihedral, w_angle):
    """Restraint energy of one conformation's dense (L, L) geometry maps,
    with tables and masks as tensors (tables_to / masks_to)."""
    def term(table, q, mask):
        return masked_spline_energy(table.y, table.m, table.x, q, mask)

    e = w_atom_pair * term(rst.dist, dist, masks.dist)
    e = e + w_dihedral * term(rst.omega, omega, masks.omega)
    e = e + w_dihedral * term(rst.theta, theta, masks.theta)
    return e + w_angle * term(rst.phi, phi, masks.phi)

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
a set of boolean (L, L) host masks (restraint_masks). The other restraint
modes: af2 (AF2 CA-CA distograms, utils_ros.py:148-194), idp (mode-relative
backgrounds on disordered pairs, :196-373) and gpcr (predicted tables
flattened where known structures agree, :375-654).
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


def compile_restraints_af2(npz: dict, params: FoldParams = FoldParams()
                           ) -> RestraintSet:
    """AF2-distogram restraints (-r af2, utils_ros.py:148-194 gen_rst_af2):
    'dist' (L, L, 64) probabilities over 'bins' bin centers -> 60-knot
    distance tables, acting on CA-CA (the folder evaluates them on CA);
    no orientation restraints, as in the reference. Quirks kept: the
    background uses only the last bin's (bins/DCUT)^ALPHA (utils_ros.py:172)
    and the cutoff is 0.0025, applied as a shift of the probability so that
    restraint_masks' pcut comparison keeps working."""
    p = params
    dist = np.asarray(npz["dist"], dtype=np.float32)
    af_bins = np.asarray(npz["bins"], dtype=np.float64)
    L = dist.shape[0]
    bins = af_bins[5:-1]
    prob = dist[:, :, 6:-1].sum(-1)
    bkgr_last = float((bins[-1] / p.DCUT) ** p.ALPHA)
    attr = (-np.log((dist[:, :, 6:-1] + p.MEFF)
                    / (dist[:, :, -2][:, :, None] * bkgr_last + 1e-6))
            + p.EBASE)
    repul = np.maximum(attr[:, :, 0], 0.0)[:, :, None] + np.asarray(p.EREP)
    ydist = np.concatenate([repul, attr], axis=-1).astype(np.float32)
    knots = np.concatenate([[0.0, 2.325, 3.575], bins])

    zeros28 = np.zeros((L, L, 28), np.float32)
    zeros16 = np.zeros((L, L, 16), np.float32)
    neg = np.full((L, L), -1.0, np.float32)
    return RestraintSet(
        dist=fit_natural_cubic(knots, ydist),
        dist_prob=prob + (0.05 - 0.0025),
        omega=fit_natural_cubic(torsion_knots(p), zeros28), omega_prob=neg,
        theta=fit_natural_cubic(torsion_knots(p), zeros28), theta_prob=neg,
        phi=fit_natural_cubic(planar_knots(p), zeros16), phi_prob=neg,
    )


def _idr_pairs(npz: dict) -> np.ndarray:
    """The (L, L) bool disorder pair mask of npz['idr'] ((L,) residue
    flags pair up by OR)."""
    idr = np.asarray(npz["idr"], dtype=bool)
    if idr.ndim == 1:
        idr = idr[:, None] | idr[None, :]
    return idr


def compile_restraints_idp(npz: dict, params: FoldParams = FoldParams(),
                           use_orient: bool = True) -> RestraintSet:
    """IDR-aware restraints (-r idp, utils_ros.py:196-373 gen_idp_rst): on
    disordered pairs (npz['idr']) the -log background is relative to the
    mode bin (distance background scaled by (x / x_mode)^ALPHA, angles by
    p_max) instead of the last bin. Tables are blended per pair; the
    activation probabilities are the standard ones."""
    p = params
    std = compile_restraints(npz, params, use_orient=use_orient)
    idr = _idr_pairs(npz)
    dist = np.asarray(npz["dist"], dtype=np.float32)
    bins = 4.25 + p.DSTEP * np.arange(32)

    mode_bin = np.argmax(dist[:, :, 5:], axis=-1)
    idr_bkgr = (bins[None, None, :] / bins[mode_bin][:, :, None]) ** p.ALPHA
    idr_attr = (-np.log((dist[:, :, 5:] + p.MEFF)
                        / (dist[:, :, 5:].max(-1)[:, :, None] * idr_bkgr
                           + 1e-6)) + p.EBASE)
    repul = np.asarray(std.dist.y)[:, :, :3]
    ydist_idr = np.concatenate([repul, idr_attr], axis=-1).astype(np.float32)
    ydist = np.where(idr[:, :, None], ydist_idr, np.asarray(std.dist.y))
    out = std._replace(dist=fit_natural_cubic(dist_knots(p), ydist))

    if use_orient:
        def idr_torsion(t):
            y = -np.log((t + p.MEFF) / (t.max(-1) + p.MEFF)[:, :, None])
            return np.concatenate([y[:, :, -2:], y[:, :, 1:], y[:, :, 1:3]],
                                  axis=-1).astype(np.float32)

        for key in ("omega", "theta"):
            t = np.asarray(npz[key], dtype=np.float32)
            y = np.where(idr[:, :, None], idr_torsion(t),
                         np.asarray(getattr(std, key).y))
            out = out._replace(**{key: fit_natural_cubic(torsion_knots(p),
                                                         y)})
        phi = np.asarray(npz["phi"], dtype=np.float32)
        yraw = -np.log((phi + p.MEFF) / (phi.max(-1) + p.MEFF)[:, :, None])
        yidr = np.concatenate([np.flip(yraw[:, :, 1:3], -1), yraw[:, :, 1:],
                               np.flip(yraw[:, :, -2:], -1)],
                              axis=-1).astype(np.float32)
        y = np.where(idr[:, :, None], yidr, np.asarray(std.phi.y))
        out = out._replace(phi=fit_natural_cubic(planar_knots(p), y))
    return out


def _gaussian_vote(onehot_stack: np.ndarray) -> np.ndarray:
    """get_sample (utils_ros.py:458-483): N known-structure one-hot
    histograms (N, L, L, C) -> a soft (L, L, C) histogram (divided by N),
    each realized bin voting a Gaussian whose width follows its vote count
    (< N/3 -> 1.5, > 2N/3 -> 0.5, else 1.0)."""
    N, _, _, C = onehot_stack.shape
    counts = onehot_stack.sum(0)                       # (L, L, C)
    std = np.where(counts < N / 3.0, 1.5,
                   np.where(counts > 2.0 * N / 3.0, 0.5, 1.0))
    x = np.arange(C, dtype=np.float64)
    out = np.zeros(counts.shape, np.float64)
    for k in range(C):
        c_k = counts[:, :, k]
        if not c_k.any():
            continue
        s = std[:, :, k][..., None]
        gauss = (np.exp(-((x[None, None, :] - k) ** 2) / (2.0 * s ** 2))
                 / np.sqrt(2.0 * np.pi * s ** 2))
        out += c_k[..., None] * gauss
    return (out / N).astype(np.float32)


def _linear_blend(test: np.ndarray, cate: np.ndarray, bins: np.ndarray,
                  mask: np.ndarray, rg: int = 5) -> np.ndarray:
    """ling_sumlt (utils_ros.py:375-394), vectorized: on masked pairs,
    replace the predicted table's values at the rg lowest-energy bins of
    the known-structure table by the line between the predicted values at
    the bracketing bins."""
    order = np.argsort(cate, axis=-1)[..., :rg]        # (L, L, rg)
    lo = order.min(-1)
    hi = order.max(-1)
    low = np.where(lo - 1 < 0, lo, lo - 1)
    high = np.where(hi + 1 >= len(bins), hi, hi + 1)
    t_low = np.take_along_axis(test, low[..., None], -1)[..., 0]
    t_high = np.take_along_axis(test, high[..., None], -1)[..., 0]
    denom = bins[low] - bins[high]
    denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    interp = ((bins[order] - bins[high][..., None]) / denom[..., None]
              * (t_low - t_high)[..., None] + t_high[..., None])
    out = test.copy()
    ii, jj = np.where(mask)
    out[ii[:, None], jj[:, None], order[ii, jj]] = interp[ii, jj]
    return out


def compile_restraints_gpcr(npz: dict, known_npz: dict,
                            params: FoldParams = FoldParams(),
                            use_orient: bool = True) -> RestraintSet:
    """GPCR two-conformation restraints (-r gpcr, utils_ros.py:484-654
    gen_gpcr_rst): the predicted tables, linearly flattened on the
    disordered pairs (npz['idr']) over the bins the known structures
    realize, so minimisation can reach either conformation.

    known_npz: real-valued maps of N known structures, 'dist' (N, L, L)
    and with use_orient 'omega', 'theta_asym', 'phi_asym' (N, L, L) (the
    reference's key names, utils_ros.py:488)."""
    from trx2dy_torch.geometry.binning import bin_geometry_maps

    p = params
    std_set = compile_restraints(npz, params, use_orient=use_orient)
    idr = _idr_pairs(npz)
    known_dist = np.asarray(known_npz["dist"], np.float32)
    N = known_dist.shape[0]

    def onehots(key_bin):
        stack = []
        for n in range(N):
            def t(key):
                return torch.as_tensor(np.asarray(known_npz[key][n],
                                                  np.float32))
            if use_orient:
                h = bin_geometry_maps(torch.as_tensor(known_dist[n]),
                                      t("omega"), t("theta_asym"),
                                      t("phi_asym"), angle=True)
            else:
                h = bin_geometry_maps(torch.as_tensor(known_dist[n]),
                                      angle=False)
            stack.append(h[key_bin].numpy())
        return np.stack(stack)

    bins_d = dist_knots(p)
    cate_dist = _gaussian_vote(onehots("dist"))
    bkgr = (bins_d[3:] / p.DCUT) ** p.ALPHA
    attr = (-np.log((cate_dist[:, :, 5:] + p.MEFF)
                    / (cate_dist[:, :, -1][:, :, None] * bkgr + 1e-6))
            + p.EBASE)
    repul = np.maximum(attr[:, :, 0], 0.0)[:, :, None] + np.asarray(p.EREP)
    cate_table = np.concatenate([repul, attr], -1).astype(np.float32)
    ydist = _linear_blend(np.asarray(std_set.dist.y), cate_table, bins_d,
                          idr)
    out = std_set._replace(dist=fit_natural_cubic(bins_d, ydist))

    if use_orient:
        def cate_torsion(key_bin):
            cate = _gaussian_vote(onehots(key_bin))
            y = -np.log((cate + p.MEFF)
                        / (cate[:, :, -1] + p.MEFF)[:, :, None])
            return np.concatenate([y[:, :, -2:], y[:, :, 1:], y[:, :, 1:3]],
                                  -1).astype(np.float32)

        tk = torsion_knots(p)
        for key in ("omega", "theta"):
            y = _linear_blend(np.asarray(getattr(out, key).y),
                              cate_torsion(key), tk, idr)
            out = out._replace(**{key: fit_natural_cubic(tk, y)})

        cate = _gaussian_vote(onehots("phi"))
        yraw = -np.log((cate + p.MEFF) / (cate[:, :, -1] + p.MEFF)[:, :, None])
        ycate = np.concatenate([np.flip(yraw[:, :, 1:3], -1), yraw[:, :, 1:],
                                np.flip(yraw[:, :, -2:], -1)],
                               -1).astype(np.float32)
        pk = planar_knots(p)
        y = _linear_blend(np.asarray(out.phi.y), ycate, pk, idr)
        out = out._replace(phi=fit_natural_cubic(pk, y))
    return out

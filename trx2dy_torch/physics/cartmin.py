"""Cartesian-DOF refinement, the torsion-space folder's stand-in for the
reference's cartesian passes.

Port of trx2dy/physics/cartmin.py for the shared-table fold. The reference
runs a cartesian MinMover after the centroid stages (folding/folding.py:169)
and a cartesian-switched FastRelax (folding.py:234,
data/2relax_round2.txt), where bonds and angles are degrees of freedom
held by Rosetta's cart_bonded term. The NeRF backbone keeps them ideal, so
this module adds per-atom displacements on top of it, minimised against

  * the restraint splines and centroid terms (vdw, hbond, rama, omega, the
    torsions re-extracted from the displaced atoms), and
  * a cart_bonded substitute: harmonic bond and angle penalties toward the
    Engh & Huber ideals of the NeRF build, and a CB tether to the virtual
    CB.

The restraint terms take compacted pair lists ("compact", through the
spline kernel's pair entry, one launch per evaluation), a shared pair list
with per-lane tables ("union", a compact.UnionStage, through the kernel's
lanes entry, one launch per evaluation; cartesian_refine_lanes), or dense
tables and masks ("dense", the reference the tests hold the compact kind
to, through the kernel's dense entry). The union kind serves both chain
folds: the sampler's tables built on the device and the host chain fold's
per-lane tables (JAX's "lanes" kind, CompactLanes), which
compact.compact_restraints_lanes builds as a UnionStage.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from trx2dy_torch.geometry.nerf import (
    ANGLE_C_N_CA, ANGLE_CA_C_N, ANGLE_CA_C_O, ANGLE_N_CA_C, BOND_C_N,
    BOND_C_O, BOND_CA_C, BOND_N_CA,
)
from trx2dy_torch.geometry.transforms import backbone_torsions, virtual_cb
from trx2dy_torch.ops.spline_energy import spline_energy_dense
from trx2dy_torch.physics.compact import (
    CompactRestraints, UnionStage, compact_restraint_energy_batch,
    compact_restraint_energy_union,
)
from trx2dy_torch.physics.energy import (
    EnergyWeights, WEIGHT_FIELDS, hbond_energy, omega_planarity_energy,
    pairwise_geometry, rama_energy, vdw_energy, weights_to_vec,
)
from trx2dy_torch.physics.minimize import (
    STATS, host_all, lbfgs_init, lbfgs_minimize, lbfgs_run,
)
from trx2dy_torch.physics.restraints import masks_to, tables_to

_ATOMS = ("N", "CA", "C", "O", "CB")

# cart_bonded-like stiffnesses (Rosetta's cart_bonded length/angle scale)
K_BOND = 300.0     # per A^2
K_ANGLE = 80.0     # per rad^2


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1) + 1e-12)


def _angle(a, b, c):
    u, v = a - b, c - b
    cosang = torch.sum(u * v, dim=-1) / (_norm(u) * _norm(v))
    return torch.arccos(torch.clamp(cosang, -1.0 + 1e-7, 1.0 - 1e-7))


def cart_bonded_energy(atoms: dict, k_bond: float = K_BOND,
                       k_angle: float = K_ANGLE, res_mask=None):
    """Harmonic ideal-geometry restoring term (cart_bonded substitute) of
    atoms (..., L, 3) -> (...)."""
    n, ca, c, o, cb = (atoms[a] for a in _ATOMS)
    L = ca.shape[-2]
    m = torch.ones((L,), dtype=torch.bool, device=ca.device) \
        if res_mask is None else res_mask
    m2 = m[:-1] & m[1:]

    def term(k, mask, dev):
        return k * torch.sum(torch.where(mask, dev ** 2, 0.0), dim=-1)

    e = term(k_bond, m, _norm(ca - n) - BOND_N_CA)
    e = e + term(k_bond, m, _norm(c - ca) - BOND_CA_C)
    e = e + term(k_bond, m, _norm(o - c) - BOND_C_O)
    e = e + term(k_bond, m2,
                 _norm(n[..., 1:, :] - c[..., :-1, :]) - BOND_C_N)
    e = e + term(k_angle, m, _angle(n, ca, c) - ANGLE_N_CA_C)
    e = e + term(k_angle, m2, _angle(ca[..., :-1, :], c[..., :-1, :],
                                     n[..., 1:, :]) - ANGLE_CA_C_N)
    e = e + term(k_angle, m2, _angle(c[..., :-1, :], n[..., 1:, :],
                                     ca[..., 1:, :]) - ANGLE_C_N_CA)
    e = e + term(k_angle, m, _angle(ca, c, o) - ANGLE_CA_C_O)
    # the centroid CB is the virtual CB by construction: tether it
    return e + k_bond * torch.sum(torch.where(m, torch.sum(
        (cb - virtual_cb(n, ca, c)) ** 2, dim=-1), 0.0), dim=-1)


def _centroid_terms(atoms: dict, w, res_mask=None):
    """The centroid terms of displaced atoms (..., L, 3), torsions
    re-extracted from them; w a dict of weights. Every term is computed
    (weights are data), as the JAX package's _cart_efun does."""
    e = w["vdw"] * vdw_energy(atoms, res_mask)
    (phi, psi, omg), _ = backbone_torsions(atoms["N"], atoms["CA"],
                                           atoms["C"])
    e = e + w["rama"] * rama_energy(phi, psi, res_mask)
    e = e + w["omega"] * omega_planarity_energy(omg, res_mask)
    return e + hbond_energy(atoms, w["cen_hb"] + w["hbond_sr"],
                            w["cen_hb"] + w["hbond_lr"], res_mask)


def atoms_energy(atoms: dict, rst, masks, w: EnergyWeights, res_mask=None):
    """The weighted term sum of explicit atoms (..., L, 3) over dense
    tables and masks as tensors (restraints.tables_to / masks_to)."""
    wd = {f: getattr(w, f) for f in WEIGHT_FIELDS}
    return _centroid_terms(atoms, wd, res_mask) + _dense_restraints(
        atoms, rst, masks, wd)


def _dense_restraints(atoms_b, rst, masks, w):
    """(B,) restraint energies of atoms (B, L, 3) over dense tables, the
    four terms through the spline kernel's dense entry."""
    g = pairwise_geometry(atoms_b)
    e = 0.0
    for wt, table, q, mask in ((w["atom_pair"], rst.dist, g["dist"],
                                masks.dist),
                               (w["dihedral"], rst.omega, g["omega"],
                                masks.omega),
                               (w["dihedral"], rst.theta, g["theta"],
                                masks.theta),
                               (w["angle"], rst.phi, g["phi"], masks.phi)):
        e = e + wt * spline_energy_dense(table.y, table.m, table.x,
                                         q.contiguous(), mask)
    return e


def _delta_unpack(atoms0: dict, delta):
    """(B, 5*L*3) flat displacements -> the displaced atoms dict."""
    B, L, _ = atoms0["N"].shape
    d = delta.reshape(B, len(_ATOMS), L, 3)
    return {nm: atoms0[nm] + d[:, i] for i, nm in enumerate(_ATOMS)}


def _cart_efun(atoms0: dict, tables, w_vec, kind: str,
               dist_on_ca: bool = False, res_mask=None):
    """delta (B, 15L) -> (B,) total cartesian-refinement energy, the score
    function as a (9,) weight tensor. kind "compact": tables a
    CompactRestraints on the device (compact.compact_to); "union", or JAX's
    name "lanes" for the host chain fold's: a compact.UnionStage (per-lane
    tables, B = the stage's lanes); "dense":
    tables (rst, masks) as tensors (restraints.tables_to / masks_to), whose
    distance is CB-CB whatever dist_on_ca says, as in JAX."""
    w = dict(zip(WEIGHT_FIELDS, w_vec))

    def restraints_b(atoms_b):
        if kind == "dense":
            return _dense_restraints(atoms_b, *tables, w)
        if kind == "compact":
            return compact_restraint_energy_batch(
                atoms_b, tables, w["atom_pair"], w["dihedral"], w["angle"],
                dist_on_ca=dist_on_ca)
        if kind in ("union", "lanes"):
            return compact_restraint_energy_union(
                atoms_b, tables, w["atom_pair"], w["dihedral"], w["angle"],
                dist_on_ca=dist_on_ca)
        raise ValueError(f"unknown cartesian energy kind {kind!r} "
                         "(compact, union or lanes, dense)")

    def efun(delta):
        atoms = _delta_unpack(atoms0, delta)
        return (_centroid_terms(atoms, w, res_mask)
                + cart_bonded_energy(atoms, res_mask=res_mask)
                + restraints_b(atoms))

    return efun


# Idealize pass (the reference's IdealizeMover fallback,
# folding/folding.py:237-268): a short tethered minimisation of
# cart_bonded alone, bonded stiffnesses scaled 10x against a tether to the
# refined coordinates, so residual bond strain relaxes to ~1 % and angle
# strain to ~10 % with sub-0.2 A movements. Its evaluations launch no
# spline kernel and count in STATS.free_evals.
IDEALIZE_ITERS = 50
IDEALIZE_SCALE = 10.0
K_TETHER = 30.0    # per A^2 per atom, toward the refined coordinates


def _idealize(atoms0, delta, res_mask=None, iters=None):
    """(the idealized displacements, iterations run)."""
    iters = IDEALIZE_ITERS if iters is None else iters
    delta = delta.detach()

    def ideal_fun(d):
        atoms = _delta_unpack(atoms0, d)
        e = cart_bonded_energy(atoms, k_bond=IDEALIZE_SCALE * K_BOND,
                               k_angle=IDEALIZE_SCALE * K_ANGLE,
                               res_mask=res_mask)
        return e + K_TETHER * torch.sum((d - delta) ** 2, dim=-1)
    with STATS.restraint_free():
        res = lbfgs_minimize(ideal_fun, delta, max_iter=iters)
    return res.x, res.n_iter


def _log(stage_log, label, iters, t0):
    if stage_log is not None:
        stage_log.append((label, iters, round(time.perf_counter() - t0, 3)))


def _table_kind(tables) -> str:
    if isinstance(tables, CompactRestraints):
        return "compact"
    if isinstance(tables, UnionStage):
        return "union"
    return "dense"


def _zero_delta(atoms):
    B, L, _ = atoms["N"].shape
    return torch.zeros((B, len(_ATOMS) * L * 3), dtype=atoms["CA"].dtype,
                       device=atoms["CA"].device)


def _w_tensor(w_vec, like):
    return torch.as_tensor(w_vec, dtype=like.dtype, device=like.device)


# cartesian L-BFGS iterations per chunk; 50 divides every stage of the
# reference ramp schedules (50/50/100/200), so a stage never overruns its
# budget and `done` is read once per chunk
CART_CHUNK = 50


def cartesian_relax_block(atoms: dict, tables, w_stages, w_full_vec,
                          dist_on_ca: bool = False, res_mask=None,
                          stage_log: Optional[list] = None):
    """One cartesian FastRelax repeat: ramp through w_stages = ((w_vec,
    iters), ...) carrying the displacement vector, in chunks of CART_CHUNK
    iterations, then accept_to_best against the starting pose under the
    full weights (1relax_round1.txt:10-16 `switch:cartesian repeat 1`).
    tables: a device CompactRestraints, a compact.UnionStage or dense
    (rst, masks) tensors.

    Returns (atoms dict, (B,) full-weight energies of the kept pose). The
    accept_to_best choice stays on the device. stage_log, if given,
    receives ("cart_r1", iterations, wall_s) per ramp stage."""
    kind = _table_kind(tables)
    delta = _zero_delta(atoms)
    like = atoms["CA"]

    def efun(w_vec):
        return _cart_efun(atoms, tables, _w_tensor(w_vec, like), kind,
                          dist_on_ca, res_mask)

    f0 = lbfgs_init(efun(w_full_vec), delta).f
    for w_vec, iters in w_stages:
        t0 = time.perf_counter()
        fun = efun(w_vec)
        st = lbfgs_init(fun, delta)
        remaining = iters
        while remaining > 0:
            st = lbfgs_run(fun, st, min(CART_CHUNK, remaining))
            remaining -= CART_CHUNK
            if host_all(st.done):
                break
        delta = st.x
        _log(stage_log, "cart_r1", st.k, t0)
    f1 = lbfgs_init(efun(w_full_vec), delta).f
    keep = f1 < f0                                   # accept_to_best
    delta = torch.where(keep[:, None], delta, 0.0)
    return _delta_unpack(atoms, delta), torch.minimum(f1, f0)


def _refine(atoms, tables, w_vec, max_iter, dist_on_ca=False,
            res_mask=None, stage_log=None):
    """L-BFGS of the cartesian energy from zero displacement, then the
    idealize pass: (refined atoms, (B,) final energies)."""
    t0 = time.perf_counter()
    efun = _cart_efun(atoms, tables, _w_tensor(w_vec, atoms["CA"]),
                      _table_kind(tables), dist_on_ca, res_mask)
    res = lbfgs_minimize(efun, _zero_delta(atoms), max_iter=max_iter)
    _log(stage_log, "cart_refine", res.n_iter, t0)
    t0 = time.perf_counter()
    delta, n_iter = _idealize(atoms, res.x, res_mask)
    _log(stage_log, "idealize", n_iter, t0)
    return _delta_unpack(atoms, delta), res.f


def cartesian_refine(atoms: dict, rst, masks, w: EnergyWeights,
                     max_iter: int = 200, res_mask=None):
    """Refine a (B, L, 3)-atom ensemble with cartesian DOFs against one
    dense restraint set (host RestraintSet and RestraintMasks), on the
    atoms' device. Returns (refined atoms, (B,) final energies with
    cart_bonded)."""
    dev, dt = atoms["CA"].device, atoms["CA"].dtype
    return _refine(atoms, (tables_to(rst, dev, dt), masks_to(masks, dev)),
                   weights_to_vec(w), max_iter, res_mask=res_mask)


def cartesian_refine_compact(atoms: dict, cr, w: EnergyWeights,
                             max_iter: int = 200, dist_on_ca: bool = False,
                             res_mask=None, stage_log: Optional[list] = None):
    """cartesian_refine against compacted active-pair tables on the atoms'
    device (a CompactRestraints from compact.compact_to): the same
    objective restricted to the active pairs, fold_ensemble's final
    stage. stage_log, if given, receives ("cart_refine", ...) and
    ("idealize", iterations, wall_s)."""
    return _refine(atoms, cr, weights_to_vec(w), max_iter, dist_on_ca,
                   res_mask, stage_log)


def cartesian_refine_lanes(atoms: dict, stage, w: EnergyWeights,
                           max_iter: int = 200, dist_on_ca: bool = False,
                           res_mask=None, stage_log: Optional[list] = None):
    """The chain folds' refinement (cartmin.py:390-420): lane k of the
    atoms (C, L, 3) refines against its own tables of a compact.UnionStage
    (the relax round-2 stage that fold_chains_pool or fold_chains builds),
    then the idealize pass.
    Returns (refined atoms, (C,) final energies)."""
    return _refine(atoms, stage, weights_to_vec(w), max_iter, dist_on_ca,
                   res_mask, stage_log)

"""Centroid-level energy terms, the PyRosetta score-function stand-in.

Port of trx2dy/physics/energy.py (weight sets from the reference's
folding/data/scorefxn*.wts). Every term takes (..., L, 3) atoms or (..., L)
torsions, so a leading decoy axis needs no vmap, and every term takes the
optional (L,) bool res_mask of length-bucket padding.

As in JAX, the weighted energies compute every term on every evaluation
with the score function as data (a (9,) weight tensor): a zero weight skips
nothing, so the number of kernel launches per evaluation is fixed.
Products that JAX pins at Precision.HIGHEST (Gram matrices) run in float32
with TF32 off (device.resolve_device).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from trx2dy_torch.geometry.nerf import build_backbone
from trx2dy_torch.geometry.transforms import bond_angle, dihedral
from trx2dy_torch.ops.spline_energy import spline_energy_dense
from trx2dy_torch.physics.compact import compact_restraint_energy_batch
from trx2dy_torch.physics.restraints import restraint_energy


class EnergyWeights(NamedTuple):
    """One Rosetta-style score function as term weights."""
    cen_hb: float = 0.0
    rama: float = 0.0
    omega: float = 0.0
    vdw: float = 0.0
    atom_pair: float = 0.0   # atom_pair_constraint
    dihedral: float = 0.0    # dihedral_constraint
    angle: float = 0.0       # angle_constraint
    hbond_sr: float = 0.0    # hbond_sr_bb (|i-j| < 5)
    hbond_lr: float = 0.0    # hbond_lr_bb


# folding/data/scorefxn.wts
SCOREFXN_CENT = EnergyWeights(cen_hb=5.0, rama=1.0, omega=0.5, vdw=1.0,
                              atom_pair=5.0, dihedral=4.0, angle=4.0)
# folding/data/scorefxn1.wts
SCOREFXN1 = EnergyWeights(cen_hb=5.0, rama=1.0, omega=0.5, vdw=3.0,
                          atom_pair=3.0, dihedral=1.0, angle=1.0)
# folding/data/scorefxn_vdw.wts
SCOREFXN_VDW = EnergyWeights(rama=1.0, vdw=1.0)
# folding/data/scorefxn_cart.wts (cart_bonded 0.1 is identically 0 here)
SCOREFXN_CART = EnergyWeights(hbond_sr=3.0, hbond_lr=3.0, rama=1.0, omega=0.5,
                              vdw=0.5, atom_pair=5.0, dihedral=4.0, angle=4.0)

# Backbone atom order and soft-sphere radii (A); CB takes the ALA-like radius
ATOM_ORDER = ("N", "CA", "C", "O", "CB")
ATOM_RADII = np.array([1.65, 1.90, 1.90, 1.48, 1.90], dtype=np.float32)

# Ramachandran 6-basin table (phi_deg, psi_deg, weight), utils_ros.py:674-696
RAMA_BASINS = np.array([
    [-140.0, 153.0, 0.135],
    [-72.0, 145.0, 0.155],
    [-122.0, 117.0, 0.073],
    [-82.0, -14.0, 0.122],
    [-61.0, -41.0, 0.497],
    [57.0, 39.0, 0.018],
], dtype=np.float32)
RAMA_KAPPA = 8.0  # von Mises concentration (~basin half-width 25 deg)

OMEGA_SIGMA = np.deg2rad(10.0)  # backbone-omega planarity width

WEIGHT_FIELDS = EnergyWeights._fields


def weights_to_vec(w: EnergyWeights) -> np.ndarray:
    """(9,) float32 host vector in WEIGHT_FIELDS order."""
    return np.asarray([getattr(w, f) for f in WEIGHT_FIELDS], np.float32)


@functools.lru_cache(maxsize=32)
def _vdw_pairs(L: int, device) -> tuple:
    """Radii sums (5L, 5L) and the static pair mask (|i-j| >= 2, upper)."""
    r = torch.as_tensor(np.tile(ATOM_RADII, L), device=device)
    res = torch.arange(L, device=device).repeat_interleave(5)
    n = torch.arange(5 * L, device=device)
    pair_ok = ((res[:, None] - res[None, :]).abs() >= 2) & (n[:, None] < n)
    return r[:, None] + r[None, :], pair_ok


@functools.lru_cache(maxsize=32)
def _residue_masks(L: int, device) -> tuple:
    """Static per-length masks, made once per (L, device): rama's interior
    residues, residues 0..L-2, and hbond's short- and long-range pairs."""
    idx = torch.arange(L, device=device)
    sep = (idx[:, None] - idx[None, :]).abs()
    return ((idx >= 1) & (idx <= L - 2), idx < L - 1,
            (sep >= 2) & (sep < 5), sep >= 5)


@functools.lru_cache(maxsize=8)
def _rama_table(device) -> tuple:
    basins = torch.as_tensor(RAMA_BASINS, device=device)
    return (torch.deg2rad(basins[:, 0]), torch.deg2rad(basins[:, 1]),
            basins[:, 2])


def _suffix_valid(L: int, res_mask, device):
    """Residues 0..L-2 with a real successor (padding is a suffix)."""
    valid = _residue_masks(L, device)[1]
    if res_mask is not None:
        nxt = torch.roll(res_mask, -1).clone()
        nxt[-1] = False
        valid = valid & res_mask & nxt
    return valid


def vdw_energy(atoms: dict, res_mask=None) -> torch.Tensor:
    """Soft-sphere repulsion over backbone-atom pairs with |i-j| >= 2:
    sum of ((sigma^2 - d^2)/sigma)^2 for d < sigma. Distances by the Gram
    matrix, as in JAX."""
    xyz = torch.stack([atoms[a] for a in ATOM_ORDER], dim=-2)  # (..., L, 5, 3)
    L = xyz.shape[-3]
    flat = xyz.reshape(*xyz.shape[:-3], 5 * L, 3)
    sig, pair_ok = _vdw_pairs(L, flat.device)
    if res_mask is not None:
        am = res_mask.repeat_interleave(5)
        pair_ok = pair_ok & am[:, None] & am[None, :]
    sq = torch.sum(flat * flat, dim=-1)
    gram = flat @ flat.transpose(-1, -2)
    d2 = torch.clamp_min(sq[..., :, None] + sq[..., None, :] - 2.0 * gram, 0.0)
    viol = torch.clamp_min(sig * sig - d2, 0.0) / sig
    return torch.sum(torch.where(pair_ok, viol * viol, 0.0), dim=(-1, -2))


def rama_energy(phi, psi, res_mask=None) -> torch.Tensor:
    """-log of the 6-basin von Mises mixture over interior residues."""
    c_phi, c_psi, w = _rama_table(phi.device)
    ll = (RAMA_KAPPA * (torch.cos(phi[..., None] - c_phi) - 1.0)
          + RAMA_KAPPA * (torch.cos(psi[..., None] - c_psi) - 1.0))
    # logsumexp with weights b, as jax.scipy.special.logsumexp computes it
    amax = ll.detach().amax(dim=-1, keepdim=True)
    e = -(torch.log(torch.sum(w * torch.exp(ll - amax), dim=-1))
          + amax[..., 0])
    L = phi.shape[-1]
    interior = _residue_masks(L, phi.device)[0]
    if res_mask is not None:
        interior = interior & _suffix_valid(L, res_mask, phi.device)
    return torch.sum(torch.where(interior, e, 0.0), dim=-1)


def omega_planarity_energy(omega, res_mask=None) -> torch.Tensor:
    """1 - cos(omega - pi) over residues 0..L-2, scaled by 1/sigma^2."""
    valid = _suffix_valid(omega.shape[-1], res_mask, omega.device)
    dev = 1.0 - torch.cos(omega - np.pi)
    return torch.sum(torch.where(valid, dev / (OMEGA_SIGMA ** 2), 0.0),
                     dim=-1)


def hbond_energy(atoms: dict, w_sr, w_lr, res_mask=None) -> torch.Tensor:
    """Backbone H-bond stand-in: -g(d_ON) a_acc a_don for |i-j| >= 2, with
    a Gaussian well at 2.95 A; short range |i-j| < 5 weighted w_sr, long
    range w_lr."""
    O, N, C, CA = atoms["O"], atoms["N"], atoms["C"], atoms["CA"]
    L = O.shape[-2]
    sqo = torch.sum(O * O, dim=-1)
    sqn = torch.sum(N * N, dim=-1)
    gram = O @ N.transpose(-1, -2)
    d = torch.sqrt(torch.clamp_min(sqo[..., :, None] + sqn[..., None, :]
                                   - 2.0 * gram, 0.0) + 1e-12)
    g = torch.exp(-((d - 2.95) ** 2) / (2.0 * 0.35 ** 2))

    co = O - C
    on = N[..., None, :, :] - O[..., :, None, :]            # (..., L, L, 3)
    cos_a = torch.sum(co[..., :, None, :] * on, dim=-1) / (
        torch.linalg.vector_norm(co, dim=-1)[..., :, None] * (d + 1e-8))
    a_acc = torch.clamp_min(cos_a, 0.0) ** 2
    nca = CA - N
    cos_d = torch.sum(-on * nca[..., None, :, :], dim=-1) / (
        torch.linalg.vector_norm(nca, dim=-1)[..., None, :] * (d + 1e-8))
    a_don = torch.clamp_min(-cos_d, 0.0)

    _, _, sr, lr = _residue_masks(L, O.device)
    if res_mask is not None:
        ok = res_mask[:, None] & res_mask[None, :]
        sr, lr = sr & ok, lr & ok
    e = -g * a_acc * a_don
    e_sr = torch.sum(torch.where(sr, e, 0.0), dim=(-1, -2))
    e_lr = torch.sum(torch.where(lr, e, 0.0), dim=(-1, -2))
    return w_sr * e_sr + w_lr * e_lr


def pairwise_geometry(atoms: dict) -> dict:
    """Dense (..., L, L) dist/omega/theta/phi maps with no contact cutoff.

    The j-side atoms are displaced by a constant offset on the diagonal
    before the angle math, so the diagonal (masked out by every consumer)
    stays finite in value and gradient."""
    n, ca, cb = atoms["N"], atoms["CA"], atoms["CB"]
    L = ca.shape[-2]
    eye = torch.eye(L, dtype=torch.bool, device=ca.device)[..., None]
    off = cb.new_tensor([7.3, 5.1, 3.7])
    sq = torch.sum(cb * cb, dim=-1)
    gram = cb @ cb.transpose(-1, -2)
    d = torch.sqrt(torch.clamp_min(sq[..., :, None] + sq[..., None, :]
                                   - 2.0 * gram, 0.0) + 1e-12)
    shape = ca.shape[:-2] + (L, L, 3)
    ca_i = ca[..., :, None, :].expand(shape)
    ca_j = torch.where(eye, ca[..., None, :, :] + off, ca[..., None, :, :])
    cb_i = cb[..., :, None, :].expand(shape)
    cb_j = torch.where(eye, cb[..., None, :, :] + off, cb[..., None, :, :])
    n_i = n[..., :, None, :].expand(shape)
    return {
        "dist": d,
        "omega": dihedral(ca_i, cb_i, cb_j, ca_j),
        "theta": dihedral(n_i, ca_i, cb_i, cb_j),
        "phi": bond_angle(ca_i, cb_i, cb_j),
    }


def _ca_dist(ca):
    sq = torch.sum(ca * ca, dim=-1)
    gram = ca @ ca.transpose(-1, -2)
    return torch.sqrt(torch.clamp_min(sq[..., :, None] + sq[..., None, :]
                                      - 2.0 * gram, 0.0) + 1e-12)


def pose_energy(torsions, rst, masks, w: EnergyWeights,
                dist_on_ca: bool = False, res_mask=None) -> torch.Tensor:
    """Total energy of one decoy, torsions (3, L); static weights skip the
    zero-weight terms. rst/masks as tensors (restraints.tables_to/masks_to)."""
    phi, psi, omg = torsions[0], torsions[1], torsions[2]
    atoms = build_backbone(phi, psi, omg)
    e = torch.zeros((), dtype=torsions.dtype, device=torsions.device)
    if w.vdw:
        e = e + w.vdw * vdw_energy(atoms, res_mask)
    if w.rama:
        e = e + w.rama * rama_energy(phi, psi, res_mask)
    if w.omega:
        e = e + w.omega * omega_planarity_energy(omg, res_mask)
    if w.cen_hb:
        e = e + w.cen_hb * hbond_energy(atoms, 1.0, 1.0, res_mask)
    if w.hbond_sr or w.hbond_lr:
        e = e + hbond_energy(atoms, w.hbond_sr, w.hbond_lr, res_mask)
    if w.atom_pair or w.dihedral or w.angle:
        g = pairwise_geometry(atoms)
        dist = _ca_dist(atoms["CA"]) if dist_on_ca else g["dist"]
        e = e + restraint_energy(rst, masks, dist, g["omega"], g["theta"],
                                 g["phi"], w.atom_pair, w.dihedral, w.angle)
    return e


def _base_energy(t, atoms, w, res_mask):
    """The non-restraint terms with weights w (dict of 0-d tensors)."""
    e = w["vdw"] * vdw_energy(atoms, res_mask)
    e = e + w["rama"] * rama_energy(t[..., 0, :], t[..., 1, :], res_mask)
    e = e + w["omega"] * omega_planarity_energy(t[..., 2, :], res_mask)
    return e + hbond_energy(atoms, w["cen_hb"] + w["hbond_sr"],
                            w["cen_hb"] + w["hbond_lr"], res_mask)


def _weights(w_vec):
    return dict(zip(WEIGHT_FIELDS, w_vec))


def pose_energy_weighted(torsions, rst, masks, w_vec,
                         dist_on_ca: bool = False, res_mask=None):
    """pose_energy with the score function as a (9,) weight tensor; every
    term is always computed."""
    w = _weights(w_vec)
    atoms = build_backbone(torsions[0], torsions[1], torsions[2])
    e = _base_energy(torsions, atoms, w, res_mask)
    g = pairwise_geometry(atoms)
    dist = _ca_dist(atoms["CA"]) if dist_on_ca else g["dist"]
    return e + restraint_energy(rst, masks, dist, g["omega"], g["theta"],
                                g["phi"], w["atom_pair"], w["dihedral"],
                                w["angle"])


def batched_energy_weighted_compact(x, cr, w_vec, dist_on_ca: bool = False,
                                    res_mask=None) -> torch.Tensor:
    """(B, 3L) flattened torsions -> (B,) energies over compacted pair
    lists (compact.compact_to), the production path of the staged fold.
    The restraint terms run pair-major through the spline kernel's pair
    entry, one launch per term."""
    w = _weights(w_vec)
    t = x.reshape(x.shape[0], 3, -1)
    atoms = build_backbone(t[:, 0], t[:, 1], t[:, 2])
    return _base_energy(t, atoms, w, res_mask) + \
        compact_restraint_energy_batch(atoms, cr, w["atom_pair"],
                                       w["dihedral"], w["angle"], dist_on_ca)


def pose_base_and_geometry(torsions, w_vec, dist_on_ca: bool = False):
    """Non-restraint energy and the four dense query maps, over leading
    axes of torsions (..., 3, L)."""
    w = _weights(w_vec)
    atoms = build_backbone(torsions[..., 0, :], torsions[..., 1, :],
                           torsions[..., 2, :])
    e = _base_energy(torsions, atoms, w, None)
    g = pairwise_geometry(atoms)
    dist = _ca_dist(atoms["CA"]) if dist_on_ca else g["dist"]
    return e, dist, g["omega"], g["theta"], g["phi"]


def batched_energy_fused(x, rst, masks, w_vec,
                         dist_on_ca: bool = False) -> torch.Tensor:
    """(B, 3L) -> (B,) energies with shared dense tables, the restraint
    terms through the spline kernel's dense entry (the JAX package's
    batched_energy_fused). rst/masks as tensors (tables_to / masks_to)."""
    t = x.reshape(x.shape[0], 3, -1)
    e, qd, qo, qt, qp = pose_base_and_geometry(t, w_vec, dist_on_ca)
    w = _weights(w_vec)
    for wt, table, q, mask in ((w["atom_pair"], rst.dist, qd, masks.dist),
                               (w["dihedral"], rst.omega, qo, masks.omega),
                               (w["dihedral"], rst.theta, qt, masks.theta),
                               (w["angle"], rst.phi, qp, masks.phi)):
        e = e + wt * spline_energy_dense(table.y, table.m, table.x,
                                         q.contiguous(), mask)
    return e

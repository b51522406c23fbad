"""Torsion-space backbone build (NeRF) by a parallel prefix composition.

Port of trx2dy/geometry/nerf.py. Each atom placement is a fixed rigid
transform parameterised by (bond, angle, torsion); the chain of 3(L-1)
transforms is composed by a log-step (Hillis-Steele) doubling over
(B, n, 3, 3) rotations and (B, n, 3) translations, the counterpart of the
JAX package's associative scan: about log2(3L) steps of a few batched
elementwise launches, not a Python loop over residues. The order in which
the products are associated changes rounding only.

Conventions (as in JAX): torsions in radians, per-residue (phi, psi,
omega) with omega[i] the CA(i)-C(i)-N(i+1)-CA(i+1) dihedral; ideal Engh &
Huber geometry; carbonyl O at torsion psi + pi about N-CA-C; CB placed
with the virtual-CB formula used for measurement.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from trx2dy_torch.geometry.transforms import virtual_cb

# Engh & Huber ideal backbone geometry
BOND_N_CA = 1.458
BOND_CA_C = 1.525
BOND_C_N = 1.329
BOND_C_O = 1.231
ANGLE_N_CA_C = np.deg2rad(111.2)
ANGLE_CA_C_N = np.deg2rad(116.2)
ANGLE_C_N_CA = np.deg2rad(121.7)
ANGLE_CA_C_O = np.deg2rad(120.8)


def _nerf_matrix(r, theta, phi):
    """(rotation (..., 3, 3), translation (..., 3)) of one placement: in the
    parent frame the new atom sits at r*(-cos t, sin t cos p, sin t sin p)
    (Parsons et al., J Comput Chem 2005). r and theta broadcast with phi."""
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    ct, st = torch.broadcast_tensors(ct, st, cp)[:2]
    zero = torch.zeros_like(cp)
    rot = torch.stack([
        torch.stack([-ct, -st, zero], -1),
        torch.stack([st * cp, -ct * cp, -sp], -1),
        torch.stack([st * sp, -ct * sp, cp], -1)], -2)
    tsl = torch.stack([-r * ct, r * st * cp, r * st * sp], -1)
    return rot, tsl


def _frame_from_three(a, b, c):
    """(rotation, origin) of the frame with origin c, x along b->c and y
    toward a in the (a, b, c) plane; rotation columns are x, y, z."""
    x = c - b
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    ab = a - b
    y = ab - torch.sum(ab * x, dim=-1, keepdim=True) * x
    y = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    z = torch.linalg.cross(x, y, dim=-1)
    return torch.stack([x, y, z], dim=-1), c


def place_atom(a, b, c, r, theta, phi):
    """Place one atom from three reference atoms and internal coordinates,
    over leading axes (used for the carbonyl O); theta a tensor."""
    rot, origin = _frame_from_three(a, b, c)
    st = torch.sin(theta)
    local = torch.stack([-r * torch.cos(theta) * torch.ones_like(phi),
                         r * st * torch.cos(phi),
                         r * st * torch.sin(phi)], dim=-1)
    return origin + torch.sum(rot * local[..., None, :], dim=-1)


def _compose(ra, ta, rb, tb):
    """(a then b): r = ra @ rb, t = ra @ tb + ta, as elementwise products
    summed in float32 (no matrix unit, so no TF32 can enter)."""
    r = torch.sum(ra[..., :, :, None] * rb[..., None, :, :], dim=-2)
    t = torch.sum(ra * tb[..., None, :], dim=-1) + ta
    return r, t


def prefix_compose(rot, tsl):
    """Inclusive prefix composition along axis -3 of rot (..., n, 3, 3) and
    axis -2 of tsl (..., n, 3): out[i] = m_0 o m_1 o ... o m_i, by
    Hillis-Steele doubling (ceil(log2 n) steps)."""
    n = rot.shape[-3]
    off = 1
    while off < n:
        r, t = _compose(rot[..., :n - off, :, :], tsl[..., :n - off, :],
                        rot[..., off:, :, :], tsl[..., off:, :])
        rot = torch.cat([rot[..., :off, :, :], r], dim=-3)
        tsl = torch.cat([tsl[..., :off, :], t], dim=-2)
        off *= 2
    return rot, tsl


@functools.lru_cache(maxsize=16)
def _constants(L: int, dtype, device):
    """Seed residue, per-step ideal bonds and angles, and the seed frame,
    made once per (L, dtype, device): a fresh host tensor per call would be
    a host-to-device copy in every energy evaluation."""
    def const(v):
        return torch.tensor(v, dtype=dtype, device=device)

    n0 = const([0.0, 0.0, 0.0])
    ca0 = const([BOND_N_CA, 0.0, 0.0])
    c0 = ca0 + BOND_CA_C * const(
        [np.cos(np.pi - ANGLE_N_CA_C), np.sin(np.pi - ANGLE_N_CA_C), 0.0])
    r = const([BOND_C_N, BOND_N_CA, BOND_CA_C]).repeat(max(L - 1, 0))
    th = const([ANGLE_CA_C_N, ANGLE_C_N_CA, ANGLE_N_CA_C]).repeat(max(L - 1, 0))
    seed_rot, seed_org = _frame_from_three(n0, ca0, c0)
    return n0, ca0, c0, r, th, seed_rot, seed_org, const(ANGLE_CA_C_O)


def build_backbone(phi, psi, omega):
    """N/CA/C/O/CB coordinates from per-residue torsions.

    phi, psi, omega: (..., L); phi[0], psi[-1] and omega[-1] are unused
    degrees of freedom. Returns dict atom -> (..., L, 3)."""
    L = phi.shape[-1]
    lead = phi.shape[:-1]
    n0, ca0, c0, r, th, seed_rot, seed_org, angle_o = _constants(
        L, phi.dtype, phi.device)

    def seed(v):
        return v.expand(*lead, 1, 3)

    if L > 1:
        # extension i -> i+1 places (N', CA', C') with torsions
        # (psi_i, omega_i, phi_{i+1}) and the cycling ideal geometry
        tors = torch.stack([psi[..., :-1], omega[..., :-1], phi[..., 1:]],
                           dim=-1).reshape(*lead, 3 * (L - 1))
        rot, tsl = _nerf_matrix(r, th, tors)
        _, cum_tsl = prefix_compose(rot, tsl)
        pos = torch.sum(seed_rot * cum_tsl[..., None, :], dim=-1) + seed_org
        pos = pos.reshape(*lead, L - 1, 3, 3)
        n = torch.cat([seed(n0), pos[..., 0, :]], dim=-2)
        ca = torch.cat([seed(ca0), pos[..., 1, :]], dim=-2)
        c = torch.cat([seed(c0), pos[..., 2, :]], dim=-2)
    else:
        n, ca, c = seed(n0), seed(ca0), seed(c0)

    o = place_atom(n, ca, c, BOND_C_O, angle_o, psi + np.pi)
    cb = virtual_cb(n, ca, c)
    return {"N": n, "CA": ca, "C": c, "O": o, "CB": cb}

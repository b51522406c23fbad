"""Vector geometry: dihedrals, angles, virtual CB, 6D geometry maps.

A frozen copy of the port's trx2dy_torch/geometry/transforms.py
(reference utils_trX2dy/utils.py:97-182). Every function broadcasts over
leading axes.
"""
from __future__ import annotations

import torch

# Virtual-CB coefficients (reference utils.py:131-135): with b = CA - N,
# c = C - CA, a = b x c:  CB = -0.58273431*a + 0.56802827*b - 0.54067466*c + CA
_VCB_A = -0.58273431
_VCB_B = 0.56802827
_VCB_C = -0.54067466

_EPS = 1e-8


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + _EPS)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def dihedral(a, b, c, d) -> torch.Tensor:
    """Signed dihedral angle a-b-c-d in radians, in (-pi, pi] (the
    praxeolitic formulation of reference utils.py:97-110)."""
    b0 = a - b
    b1 = _normalize(c - b)
    b2 = d - c
    v = b0 - _dot(b0, b1)[..., None] * b1
    w = b2 - _dot(b2, b1)[..., None] * b1
    x = _dot(v, w)
    y = _dot(torch.linalg.cross(b1, v, dim=-1), w)
    return torch.atan2(y, x)


def bond_angle(a, b, c) -> torch.Tensor:
    """Planar angle a-b-c in radians, in [0, pi] (reference utils.py:113-122).

    The cosine is clipped strictly inside (-1, 1): arccos' derivative is
    infinite at the endpoints."""
    v = _normalize(a - b)
    w = _normalize(c - b)
    cos = torch.clamp(_dot(v, w), -1.0 + 1e-7, 1.0 - 1e-7)
    return torch.arccos(cos)


def virtual_cb(n, ca, c) -> torch.Tensor:
    """Virtual C-beta from backbone N/CA/C (reference utils.py:131-135)."""
    b = ca - n
    cc = c - ca
    a = torch.linalg.cross(b, cc, dim=-1)
    return _VCB_A * a + _VCB_B * b + _VCB_C * cc + ca


def geometry_maps_6d(n, ca, c, cb=None, dmax: float = 20.0, atom_mask=None):
    """Dense (..., L, L) dist/omega/theta/phi maps of backbones, zeroed
    beyond dmax, on the diagonal and (with atom_mask) on absent residues.

    n, ca, c, cb: (..., L, 3), any leading axes (a batch of decoys); cb
    defaults to the virtual CB."""
    L = ca.shape[-2]
    if cb is None:
        cb = virtual_cb(n, ca, c)
    d2 = torch.sum((cb[..., :, None, :] - cb[..., None, :, :]) ** 2, dim=-1)
    d = torch.sqrt(d2 + _EPS ** 2)
    eye = torch.eye(L, dtype=torch.bool, device=ca.device)
    mask = (d <= dmax) & ~eye
    if atom_mask is not None:
        mask = mask & atom_mask[..., :, None] & atom_mask[..., None, :]
    shape = ca.shape[:-2] + (L, L, 3)
    ca_i = ca[..., :, None, :].expand(shape)
    ca_j = ca[..., None, :, :].expand(shape)
    cb_i = cb[..., :, None, :].expand(shape)
    cb_j = cb[..., None, :, :].expand(shape)
    n_i = n[..., :, None, :].expand(shape)
    z = torch.zeros_like(d)
    return {
        "dist": torch.where(mask, d, z),
        "omega": torch.where(mask, dihedral(ca_i, cb_i, cb_j, ca_j), z),
        "theta": torch.where(mask, dihedral(n_i, ca_i, cb_i, cb_j), z),
        "phi": torch.where(mask, bond_angle(ca_i, cb_i, cb_j), z),
    }


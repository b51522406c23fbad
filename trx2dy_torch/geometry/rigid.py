"""Rigid transforms for the torsion -> frames -> atom14 build.

The subset of trx2dy/geometry/rigid.py that sidechain packing needs (the
reference's OpenFold-style Rigid, rigid_utils.py:333,865): a rigid is a
(rot (..., 3, 3), trans (..., 3)) NamedTuple, and every function
broadcasts over leading axes. Products are sums of elementwise float32
products, so no TF32 can enter (JAX pins Precision.HIGHEST on them).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Rigid(NamedTuple):
    rot: torch.Tensor    # (..., 3, 3)
    trans: torch.Tensor  # (..., 3)


def _matvec(rot, v):
    return torch.sum(rot * v[..., None, :], dim=-1)


def rigid_apply(r: Rigid, pts: torch.Tensor) -> torch.Tensor:
    """Apply r to points (..., 3); r broadcasts over leading axes."""
    return _matvec(r.rot, pts) + r.trans


def rigid_compose(a: Rigid, b: Rigid) -> Rigid:
    """a then b in a's frame: (Ra Rb, Ra tb + ta)."""
    rot = torch.sum(a.rot[..., :, :, None] * b.rot[..., None, :, :], dim=-2)
    return Rigid(rot, _matvec(a.rot, b.trans) + a.trans)


def rigid_from_tensor_4x4(t: torch.Tensor) -> Rigid:
    return Rigid(t[..., :3, :3], t[..., :3, 3])


def make_transform_from_reference(n, ca, c) -> Rigid:
    """Gram-Schmidt backbone frame (rigid_utils.py:1226-1290 from_3_points
    convention): origin CA, x toward C."""
    e1 = c - ca
    e1 = e1 / torch.linalg.vector_norm(e1, dim=-1, keepdim=True)
    u2 = n - ca
    e2 = u2 - torch.sum(u2 * e1, dim=-1, keepdim=True) * e1
    e2 = e2 / torch.linalg.vector_norm(e2, dim=-1, keepdim=True)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return Rigid(torch.stack([e1, e2, e3], dim=-1), ca)

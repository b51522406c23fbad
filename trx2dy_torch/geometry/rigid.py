"""Rigid transforms and quaternions for the structure module and the
torsion -> frames -> atom14 build.

Port of trx2dy/geometry/rigid.py (the reference's OpenFold-style Rotation
and Rigid, rigid_utils.py:207-331,333,865): a rigid is a (rot (..., 3, 3),
trans (..., 3)) NamedTuple, quaternions are (w, x, y, z) tensors (..., 4),
and every function broadcasts over leading axes. Products are sums of
elementwise float32 products, so no TF32 can enter (JAX pins
Precision.HIGHEST on them).
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


def rigid_invert_apply(r: Rigid, pts: torch.Tensor) -> torch.Tensor:
    """The inverse of r applied to points (..., 3): R^T (pts - t)."""
    return torch.sum(r.rot * (pts - r.trans)[..., :, None], dim=-2)


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


def identity_rigid(shape, dtype=torch.float32, device=None) -> Rigid:
    rot = torch.eye(3, dtype=dtype, device=device).expand(*shape, 3, 3)
    return Rigid(rot, torch.zeros(*shape, 3, dtype=dtype, device=device))


def identity_quats(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    q = torch.zeros(*shape, 4, dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)
    (rigid_utils.py:207-240, the _QTR_MAT expansion)."""
    w, x, y, z = q.unbind(-1)
    tw, tx, ty, tz = 2 * w, 2 * x, 2 * y, 2 * z
    r = torch.stack([
        1 - ty * y - tz * z, tx * y - tw * z, tx * z + tw * y,
        tx * y + tw * z, 1 - tx * x - tz * z, ty * z - tw * x,
        tx * z - tw * y, ty * z + tw * x, 1 - tx * x - ty * y,
    ], dim=-1)
    return r.unflatten(-1, (3, 3))


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_multiply_by_vec(quat: torch.Tensor, vec: torch.Tensor
                         ) -> torch.Tensor:
    """Product of quaternion (a, b, c, d) with the pure-vector quaternion
    (0, x, y, z) (rigid_utils.py:274-295, _QUAT_MULTIPLY_BY_VEC)."""
    a, b, c, d = quat.unbind(-1)
    x, y, z = vec.unbind(-1)
    return torch.stack([
        -b * x - c * y - d * z,
        a * x + c * z - d * y,
        a * y - b * z + d * x,
        a * z + b * y - c * x,
    ], dim=-1)


def rigid_to_tensor_7(quats: torch.Tensor, trans: torch.Tensor
                      ) -> torch.Tensor:
    return torch.cat([quats, trans], dim=-1)


def compose_q_update(quats: torch.Tensor, trans: torch.Tensor,
                     update: torch.Tensor):
    """AF2 Algorithm 23's backbone update (rigid_utils.py:603-626,
    1052-1087): update (..., 6) = (b, c, d, tx, ty, tz). The quaternion
    (1, b, c, d) right-multiplies (additively, by the bilinear table), then
    normalises; the translation update is rotated by the pre-update
    rotation. Returns (new_quats, new_trans)."""
    q_vec, t_vec = update[..., :3], update[..., 3:]
    new_quats = quat_normalize(quats + quat_multiply_by_vec(quats, q_vec))
    rot = quat_to_rot(quat_normalize(quats))
    return new_quats, _matvec(rot, t_vec) + trans

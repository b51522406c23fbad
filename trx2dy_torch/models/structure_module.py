"""Torsion angles -> rigid-group frames -> atom14 coordinates.

The part of trx2dy/models/structure_module.py that sidechain packing needs
(structure_module.py:129-175, after the reference's ProtConverter,
prot_converter.py:60-185). Both functions broadcast over leading axes of
the backbone frames, so a decoy batch needs no loop. IPA and the rest of
the structure module come with the e2e slice of the port.
"""
from __future__ import annotations

import functools

import torch

from trx2dy_torch.geometry.rigid import (
    Rigid, rigid_apply, rigid_compose, rigid_from_tensor_4x4,
)
from trx2dy_torch.models import constants as rc


@functools.lru_cache(maxsize=8)
def _tables(dtype, device) -> tuple:
    """The residue tables as tensors, made once per (dtype, device)."""
    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)
    return (t(rc.restype_rigid_group_default_frame),
            t(rc.restype_atom14_to_rigid_group, torch.int64),
            t(rc.restype_atom14_rigid_group_positions),
            t(rc.restype_atom14_mask))


def torsion_angles_to_frames(rig: Rigid, alpha: torch.Tensor,
                             aatype: torch.Tensor) -> Rigid:
    """prot_converter.py:60-146: backbone frames rig (..., L), 7 (sin, cos)
    torsion angles alpha (..., L, 7, 2), aatype (L,) -> 8 global frames per
    residue (..., L, 8)."""
    default, _, _, _ = _tables(alpha.dtype, alpha.device)
    default_r = rigid_from_tensor_4x4(default[aatype])        # (L, 8)

    bb_rot = torch.zeros_like(alpha[..., :1, :])
    bb_rot[..., 1] = 1.0
    alpha = torch.cat([bb_rot, alpha], dim=-2)                # (..., L, 8, 2)
    s, c = alpha[..., 0], alpha[..., 1]
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    all_rots = torch.stack([
        torch.stack([one, zero, zero], -1),
        torch.stack([zero, c, -s], -1),
        torch.stack([zero, s, c], -1)], -2)                   # (..., L, 8, 3, 3)

    all_frames = rigid_compose(
        default_r, Rigid(all_rots, torch.zeros_like(all_rots[..., 0])))

    def group(g):
        return Rigid(all_frames.rot[..., g, :, :], all_frames.trans[..., g, :])

    c2 = rigid_compose(group(4), group(5))
    c3 = rigid_compose(c2, group(6))
    c4 = rigid_compose(c3, group(7))
    rot = torch.cat([all_frames.rot[..., :5, :, :]]
                    + [f.rot[..., None, :, :] for f in (c2, c3, c4)], dim=-3)
    trans = torch.cat([all_frames.trans[..., :5, :]]
                      + [f.trans[..., None, :] for f in (c2, c3, c4)], dim=-2)
    return rigid_compose(Rigid(rig.rot[..., None, :, :],
                               rig.trans[..., None, :]), Rigid(rot, trans))


def frames_to_atom14(frames: Rigid, aatype: torch.Tensor):
    """prot_converter.py:149-185: each literature position in its rigid
    group's global frame -> atom14 coordinates (..., L, 14, 3) and mask
    (L, 14). The group is selected by index (JAX's one-hot product at
    Precision.HIGHEST is an exact selection)."""
    _, group, lit, mask = _tables(frames.rot.dtype, frames.rot.device)
    group, lit, mask = group[aatype], lit[aatype], mask[aatype]  # (L, 14)
    lead = frames.rot.shape[:-4]
    idx = group.expand(*lead, *group.shape)                      # (..., L, 14)
    rot = torch.gather(frames.rot, -3, idx[..., None, None].expand(
        *idx.shape, 3, 3))
    trans = torch.gather(frames.trans, -2, idx[..., None].expand(
        *idx.shape, 3))
    xyz = rigid_apply(Rigid(rot, trans), lit) * mask[..., None]
    return xyz, mask

"""AF2-style structure module (IPA) and the full-atom coordinate build.

Port of trx2dy/models/structure_module.py, after the reference's
StructureModuleFullAtom (strutils/structure_module.py:571-780) and
ProtConverter (strutils/utils_3d/prot_converter.py:60-290). Per block:
invariant point attention (Algorithm 22), layer norm, transition, the
6-DoF quaternion backbone update, the angle resnet; then
torsion_angles_to_frames and the literature-position atom14 placement.
The rigid state of the loop is carried as explicit (quats, trans)
tensors; the IPA weights are shared by every block.

Module and parameter names follow the checkpoint (under
`structure_module.` in the e2e model): `ipa.*`, `angle_resnet.*`,
`transition.*`, `bb_update.linear`, `layer_norm_{s,z,ipa}`, `linear_in`.
Products go through predictor2d.Linear, so bf16 weights follow JAX's rule.
torsion_angles_to_frames and frames_to_atom14 broadcast over leading axes
of the backbone frames; sidechain packing uses them on decoy batches.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from trx2dy_torch.geometry.rigid import (
    Rigid, compose_q_update, identity_quats, quat_normalize, quat_to_rot,
    rigid_apply, rigid_compose, rigid_from_tensor_4x4, rigid_invert_apply,
)
from trx2dy_torch.models import constants as rc
from trx2dy_torch.models.predictor2d import LayerNorm, Linear


class SMConfig(NamedTuple):
    """The structure_module keys of model_1.json (predict.py:118-121)."""
    c_s: int = 128
    c_z: int = 128
    c_ipa: int = 16
    c_resnet: int = 128
    no_heads_ipa: int = 12
    no_qk_points: int = 4
    no_v_points: int = 8
    no_blocks: int = 8
    no_transition_layers: int = 1
    no_resnet_blocks: int = 2
    no_angles: int = 7
    trans_scale_factor: float = 10.0


class InvariantPointAttention(nn.Module):
    """IPA (structure_module.py:266-490): s (L, c_s), z (L, L, c_z),
    backbone frames (rot (L, 3, 3), trans (L, 3)), mask (L,)."""

    def __init__(self, cfg: SMConfig):
        super().__init__()
        self.cfg = cfg
        H, C = cfg.no_heads_ipa, cfg.c_ipa
        Pq, Pv = cfg.no_qk_points, cfg.no_v_points
        self.linear_q = Linear(cfg.c_s, H * C)
        self.linear_kv = Linear(cfg.c_s, 2 * H * C)
        self.linear_q_points = Linear(cfg.c_s, H * Pq * 3)
        self.linear_kv_points = Linear(cfg.c_s, H * (Pq + Pv) * 3)
        self.linear_b = Linear(cfg.c_z, H)
        self.head_weights = nn.Parameter(torch.zeros(H))
        self.linear_out = Linear(H * (C + cfg.c_z + 4 * Pv), cfg.c_s)

    def _points(self, lin, s, rig: Rigid, n: int):
        # the reference's layout: 3 chunks of H*n, stacked as x, y, z
        pts = torch.stack(torch.chunk(lin(s), 3, dim=-1), dim=-1)
        pts = rigid_apply(Rigid(rig.rot[:, None], rig.trans[:, None]), pts)
        return pts.reshape(s.shape[0], self.cfg.no_heads_ipa, n, 3)

    def forward(self, s, z, rig: Rigid, mask):
        cfg = self.cfg
        L = s.shape[0]
        H, C, Pq, Pv = (cfg.no_heads_ipa, cfg.c_ipa, cfg.no_qk_points,
                        cfg.no_v_points)
        q = self.linear_q(s).reshape(L, H, C)
        k, v = torch.chunk(self.linear_kv(s).reshape(L, H, 2 * C), 2, dim=-1)
        q_pts = self._points(self.linear_q_points, s, rig, Pq)
        kv_pts = self._points(self.linear_kv_points, s, rig, Pq + Pv)
        k_pts, v_pts = kv_pts[:, :, :Pq], kv_pts[:, :, Pq:]
        b = self.linear_b(z)                                  # (L, L, H)

        a = torch.einsum("ihc,jhc->hij", q, k) * math.sqrt(1.0 / (3 * C))
        a = a + math.sqrt(1.0 / 3) * b.permute(2, 0, 1)
        d2 = torch.sum((q_pts[:, None] - k_pts[None, :]) ** 2, dim=-1)
        head_w = F.softplus(self.head_weights) \
            * math.sqrt(1.0 / (3 * (Pq * 9.0 / 2)))
        pt_att = torch.sum(d2 * head_w[:, None], dim=-1) * (-0.5)
        a = a + pt_att.permute(2, 0, 1)
        sq_mask = 1e5 * (mask[:, None] * mask[None, :] - 1.0)
        a = torch.softmax(a + sq_mask[None], dim=-1)         # (H, L, L)

        o = torch.einsum("hij,jhc->ihc", a, v).reshape(L, -1)
        o_pt = torch.einsum("hij,jhpx->ihpx", a, v_pts)
        o_pt = rigid_invert_apply(
            Rigid(rig.rot[:, None, None], rig.trans[:, None, None]), o_pt)
        o_pt_norm = torch.sqrt(torch.sum(o_pt ** 2, dim=-1) + 1e-8) \
            .reshape(L, -1)
        o_pt = o_pt.reshape(L, -1, 3)                         # (L, H*Pv, 3)
        o_pair = torch.einsum("hij,ijc->ihc", a, z).reshape(L, -1)
        return self.linear_out(torch.cat(
            [o, o_pt[..., 0], o_pt[..., 1], o_pt[..., 2], o_pt_norm, o_pair],
            dim=-1))


class _ResnetBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.linear_1 = Linear(c, c)
        self.linear_2 = Linear(c, c)

    def forward(self, x):
        return x + self.linear_2(F.relu(self.linear_1(F.relu(x))))


class AngleResnet(nn.Module):
    """AngleResnet (structure_module.py:184-263): (unnormalised, unit)
    (sin, cos) pairs, (L, no_angles, 2) each."""

    def __init__(self, cfg: SMConfig):
        super().__init__()
        self.no_angles = cfg.no_angles
        self.linear_in = Linear(cfg.c_s, cfg.c_resnet)
        self.linear_initial = Linear(cfg.c_s, cfg.c_resnet)
        self.layers = nn.ModuleList(_ResnetBlock(cfg.c_resnet)
                                    for _ in range(cfg.no_resnet_blocks))
        self.linear_out = Linear(cfg.c_resnet, cfg.no_angles * 2)

    def forward(self, s, s_initial):
        x = self.linear_in(F.relu(s)) + self.linear_initial(F.relu(s_initial))
        for layer in self.layers:
            x = layer(x)
        out = self.linear_out(F.relu(x)).unflatten(-1, (self.no_angles, 2))
        norm = torch.sqrt(torch.clamp_min(
            torch.sum(out ** 2, dim=-1, keepdim=True), 1e-8))
        return out, out / norm


class _TransitionLayer(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.linear_1 = Linear(c, c)
        self.linear_2 = Linear(c, c)
        self.linear_3 = Linear(c, c)

    def forward(self, s):
        return s + self.linear_3(F.relu(self.linear_2(F.relu(
            self.linear_1(s)))))


class Transition(nn.Module):
    def __init__(self, cfg: SMConfig):
        super().__init__()
        self.layers = nn.ModuleList(_TransitionLayer(cfg.c_s)
                                    for _ in range(cfg.no_transition_layers))
        self.layer_norm = LayerNorm(cfg.c_s)

    def forward(self, s):
        for layer in self.layers:
            s = layer(s)
        return self.layer_norm(s)


class BackboneUpdate(nn.Module):
    def __init__(self, c_s: int):
        super().__init__()
        self.linear = Linear(c_s, 6)

    def forward(self, s):
        return self.linear(s)


class StructureModule(nn.Module):
    """StructureModuleFullAtom's forward (structure_module.py:678-780)."""

    def __init__(self, cfg: SMConfig = SMConfig()):
        super().__init__()
        self.cfg = cfg
        self.layer_norm_s = LayerNorm(cfg.c_s)
        self.layer_norm_z = LayerNorm(cfg.c_z)
        self.linear_in = Linear(cfg.c_s, cfg.c_s)
        self.ipa = InvariantPointAttention(cfg)
        self.layer_norm_ipa = LayerNorm(cfg.c_s)
        self.transition = Transition(cfg)
        self.bb_update = BackboneUpdate(cfg.c_s)
        self.angle_resnet = AngleResnet(cfg)

    def forward(self, single, pair, aatype, mask=None,
                no_blocks: Optional[int] = None):
        """single (L, c_s), pair (L, L, c_z), aatype (L,) int. no_blocks
        overrides the config's count (the weights are shared by every
        block). Returns 'frames' (quats + trans, (L, 7)), 'angles' and
        'unnormalized_angles' (L, 7, 2), 'single' (L, c_s), 'cords_ca'
        (L, 3), 'atom14' (L, 14, 3) and 'atom14_mask' (L, 14)."""
        cfg = self.cfg
        no_blocks = cfg.no_blocks if no_blocks is None else no_blocks
        L = single.shape[0]
        if mask is None:
            mask = torch.ones(L, dtype=single.dtype, device=single.device)
        s = self.layer_norm_s(single)
        z = self.layer_norm_z(pair)
        s_initial = s
        s = self.linear_in(s)
        quats = identity_quats((L,), s.dtype, s.device)
        trans = torch.zeros(L, 3, dtype=s.dtype, device=s.device)
        angles = unnormalized = None
        for i in range(no_blocks):
            rig = Rigid(quat_to_rot(quat_normalize(quats)), trans)
            s = s + self.ipa(s, z, rig, mask)
            s = self.transition(self.layer_norm_ipa(s))
            quats, trans = compose_q_update(quats, trans, self.bb_update(s))
            unnormalized, angles = self.angle_resnet(s, s_initial)
            if i != no_blocks - 1:
                quats = quats.detach()              # stop_rot_gradient
        scaled = trans * cfg.trans_scale_factor
        unit = quat_normalize(quats)
        out = {"frames": torch.cat([unit, scaled], dim=-1),
               "angles": angles, "unnormalized_angles": unnormalized,
               "single": s, "cords_ca": scaled}
        frames = torsion_angles_to_frames(
            Rigid(quat_to_rot(unit), scaled), angles, aatype)
        out["atom14"], out["atom14_mask"] = frames_to_atom14(frames, aatype)
        return out


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

"""Sidechain packing: backbone decoys -> full-atom (atom14) structures.

Port of trx2dy/physics/sidechain.py. The reference relaxes with sidechain
degrees of freedom in the full-atom residue set and dumps full-atom PDBs
(folding/folding.py:200-273); it re-detects disulfides before relax round 2
(:233). Here the chi torsions of the whole decoy ensemble are packed as one
batched L-BFGS over (B, L, 4) angles:

  build   backbone frames from the folded N/CA/C (Gram-Schmidt), then AF2's
          torsion -> frames -> atom14 build (models/structure_module.py);
  energy  soft-sphere clash over atom14 pairs (AF2 van der Waals radii), a
          rotamer prior (von Mises mixture at the staggered chi minima) and
          a harmonic well on detected CYS SG pairs;
  pack    L-BFGS over the chi angles, backbone frozen.

The backbone slots of the emitted atom14 are the folded coordinates
themselves, so packing never moves the backbone. Every function takes a
leading decoy axis. The clash energy is dense over the (14 L)^2 atom pairs
of each decoy, by the Gram form |a|^2 + |b|^2 - 2 a.b as in JAX (TF32 is
off, device.resolve_device); it has no restraint term and launches no
kernel of the port.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from trx2dy_torch.device import resolve_device
from trx2dy_torch.geometry.nerf import build_backbone
from trx2dy_torch.geometry.rigid import make_transform_from_reference
from trx2dy_torch.models import constants as rc
from trx2dy_torch.models.structure_module import (
    frames_to_atom14, torsion_angles_to_frames,
)
from trx2dy_torch.physics.minimize import STATS, lbfgs_minimize

# atom14 slots of the backbone atoms (AF2 layout: N, CA, C, O first, CB
# fifth where present)
_BB_SLOTS = {"N": 0, "CA": 1, "C": 2, "O": 3}
_CB_SLOT = 4

# staggered chi rotamer minima and prior width
_ROTAMER_CENTERS = np.deg2rad([-60.0, 60.0, 180.0]).astype(np.float32)
_ROTAMER_KAPPA = 4.0
W_CLASH = 1.0
W_ROTAMER = 0.25
W_SS = 10.0
SS_BOND_LENGTH = 2.05      # S-S bond (A)
SS_DETECT_CB = 4.5         # CB-CB detection cutoff (A)
CLASH_TOL = 0.5            # soft tolerance subtracted from radii sums (A)


def _atom14_radii() -> np.ndarray:
    """(21, 14) van der Waals radius by element of each atom14 slot."""
    rad = np.zeros((rc.restype_num + 1, 14), np.float32)
    for r in range(rc.restype_num + 1):
        for a in range(14):
            name = str(rc.atom14_names[r, a])
            if name:
                rad[r, a] = rc.van_der_waals_radius[name[0]]
    return rad


ATOM14_RADII = _atom14_radii()


class PackInput(NamedTuple):
    """Per-target tensors shared across the decoy batch (pack_input)."""
    aatype: torch.Tensor       # (L,) int64
    radii: torch.Tensor        # (L, 14)
    atom_mask: torch.Tensor    # (L, 14)
    chi_mask: torch.Tensor     # (L, 4)
    sg_slot: int               # atom14 slot of CYS SG
    sig: torch.Tensor          # (14L, 14L) clash radii sums
    pair_mask: torch.Tensor    # (14L, 14L) bool, the pairs the clash counts


def _clash_pairs(aatype: np.ndarray, radii: np.ndarray, amask: np.ndarray):
    """(sig, pair_mask) of _clash_energy (sidechain.py:154-190), host numpy.

    Pairs of different residues where one atom is past CB, except
    adjacent residues' backbone/CB pairs; within a residue only N/O against
    atoms of slot >= 6 (delta and beyond: the gamma 1-4 pairs are left to
    the rotamer prior); both atoms present; each pair once."""
    L = len(aatype)
    r = radii.reshape(-1)
    am = amask.reshape(-1)
    res = np.repeat(np.arange(L), 14)
    slot = np.tile(np.arange(14), L)
    is_bb = slot <= _CB_SLOT
    same = res[:, None] == res[None, :]
    adjacent = np.abs(res[:, None] - res[None, :]) == 1
    bb_pair = is_bb[:, None] & is_bb[None, :]
    no = (slot == 0) | (slot == 3)
    deep = slot >= 6
    intra_ok = same & ((no[:, None] & deep[None, :])
                       | (deep[:, None] & no[None, :]))
    inter_ok = ~same & ~bb_pair & ~(adjacent & bb_pair)
    n = np.arange(L * 14)
    pair_mask = ((intra_ok | inter_ok) & (am[:, None] * am[None, :] > 0)
                 & (n[:, None] < n[None, :]))
    sig = np.maximum(r[:, None] + r[None, :] - CLASH_TOL, 1e-3)
    return sig.astype(np.float32), pair_mask


def pack_input(seq: str, device="cpu", dtype=torch.float32) -> PackInput:
    aatype = rc.sequence_to_aatype(seq)
    cys = rc.restype_order.get("C", 1)
    sg_slot = int(np.argmax(rc.atom14_names[cys] == "SG"))
    radii = ATOM14_RADII[aatype]
    amask = rc.restype_atom14_mask[aatype]
    sig, pair_mask = _clash_pairs(aatype, radii, amask)

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)
    return PackInput(
        aatype=t(aatype, torch.int64), radii=t(radii), atom_mask=t(amask),
        chi_mask=t(rc.chi_angles_mask[aatype]), sg_slot=sg_slot,
        sig=t(sig), pair_mask=t(pair_mask, torch.bool))


def _atom14(bb, atoms, psi, chi, pin: PackInput, pin_backbone: bool):
    """atom14 (..., L, 14, 3) and mask (L, 14) from backbone frames bb, the
    backbone atoms, psi (..., L) and chi (..., L, 4)."""
    chi = chi * pin.chi_mask
    ang = torch.stack([torch.sin(chi), torch.cos(chi)], dim=-1)  # (.., L, 4, 2)
    zero = torch.zeros_like(ang[..., :1, :])
    zero[..., 1] = 1.0
    psi_ang = torch.stack([torch.sin(psi), torch.cos(psi)], dim=-1)[..., None, :]
    # alpha slots: pre-omega, phi (atom14-empty groups), psi, chi1..4
    alpha = torch.cat([zero, zero, psi_ang, ang], dim=-2)         # (.., L, 7, 2)
    frames = torsion_angles_to_frames(bb, alpha, pin.aatype)
    xyz, mask = frames_to_atom14(frames, pin.aatype)
    if pin_backbone:
        # the backbone slots are the folded coordinates exactly
        xyz = torch.cat([torch.stack([atoms[name] for name in _BB_SLOTS],
                                     dim=-2), xyz[..., len(_BB_SLOTS):, :]],
                        dim=-2)
    return xyz, mask


def _backbone(torsions, backbone):
    """(atoms, frames) of the backbone the sidechains pack onto."""
    atoms = backbone if backbone is not None else \
        build_backbone(torsions[..., 0, :], torsions[..., 1, :],
                       torsions[..., 2, :])
    return atoms, make_transform_from_reference(atoms["N"], atoms["CA"],
                                                atoms["C"])


def atom14_from_torsions(torsions: torch.Tensor, chi: torch.Tensor,
                         pin: PackInput, pin_backbone: bool = True,
                         backbone=None):
    """(..., 3, L) backbone torsions + (..., L, 4) chi -> (atom14
    (..., L, 14, 3), mask (L, 14), backbone atoms).

    The psi rigid group's angle is the psi torsion: NeRF places O at
    dihedral(N, CA, C, O) = psi + pi, as AF2's psi-group O. backbone: an
    optional N/CA/C/O/CB atom dict (..., L, 3) to pack onto instead of the
    ideal NeRF build (the cartesian-refined backbone keeps its small
    non-ideal displacements)."""
    atoms, bb = _backbone(torsions, backbone)
    xyz, mask = _atom14(bb, atoms, torsions[..., 1, :], chi, pin,
                        pin_backbone)
    return xyz, mask, atoms


def detect_disulfides(cb: np.ndarray, seq: str,
                      cutoff: float = SS_DETECT_CB) -> np.ndarray:
    """Greedy CYS pairing by CB-CB distance (host numpy), the reference's
    detect_disulfides at the resolution available before packing
    (folding.py:48,233). Returns (n_pairs, 2) int32."""
    cys = np.array([i for i, a in enumerate(seq) if a == "C"])
    pairs = []
    if len(cys) >= 2:
        d = np.linalg.norm(cb[cys][:, None] - cb[cys][None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        used = set()
        for k in np.argsort(d, axis=None):
            i, j = np.unravel_index(k, d.shape)
            if i in used or j in used or d[i, j] > cutoff:
                continue
            pairs.append((int(cys[i]), int(cys[j])))
            used.update((int(i), int(j)))
    return np.asarray(pairs, np.int32).reshape(-1, 2)


def _clash_energy(xyz: torch.Tensor, pin: PackInput) -> torch.Tensor:
    """Soft-sphere repulsion over the atom14 pairs of pin.pair_mask,
    (..., L, 14, 3) -> (...)."""
    flat = xyz.flatten(-3, -2)                            # (..., 14L, 3)
    sq = torch.sum(flat * flat, dim=-1)
    gram = flat @ flat.transpose(-1, -2)
    d2 = torch.clamp_min(sq[..., :, None] + sq[..., None, :] - 2.0 * gram,
                         0.0)
    sig = pin.sig
    viol = torch.clamp_min(sig * sig - d2, 0.0) / sig
    return torch.sum(torch.where(pin.pair_mask, viol * viol, 0.0),
                     dim=(-1, -2))


def _rotamer_energy(chi: torch.Tensor, pin: PackInput) -> torch.Tensor:
    """-log of the equal-weight von Mises mixture at the staggered minima,
    per active chi: (..., L, 4) -> (...)."""
    centers = torch.as_tensor(_ROTAMER_CENTERS, dtype=chi.dtype,
                              device=chi.device)
    ll = _ROTAMER_KAPPA * (torch.cos(chi[..., None] - centers) - 1.0)
    # logsumexp with weights b = 1/3 (jax.scipy.special.logsumexp's b=)
    e = -(torch.logsumexp(ll, dim=-1) + np.log(1.0 / 3.0))
    return torch.sum(e * pin.chi_mask, dim=(-1, -2))


def _disulfide_energy(xyz: torch.Tensor, pairs: torch.Tensor,
                      pin: PackInput) -> torch.Tensor:
    """Harmonic well |SG_i - SG_j| -> 2.05 A over detected pairs."""
    if pairs.shape[0] == 0:
        return torch.zeros(xyz.shape[:-3], dtype=xyz.dtype,
                           device=xyz.device)
    sg = xyz[..., pin.sg_slot, :]
    d = torch.linalg.vector_norm(sg[..., pairs[:, 0], :]
                                 - sg[..., pairs[:, 1], :] + 1e-9, dim=-1)
    return torch.sum((d - SS_BOND_LENGTH) ** 2, dim=-1)


def _pack_energy(chi_flat: torch.Tensor, torsions: torch.Tensor,
                 pairs: torch.Tensor, pin: PackInput,
                 backbone=None) -> torch.Tensor:
    """(B, 4L) chi of (B, 3, L) torsions -> (B,) packing energies."""
    atoms, bb = _backbone(torsions, backbone)
    return _pack_objective(atoms, bb, torsions[..., 1, :], pairs, pin)(
        chi_flat)


def _pack_objective(atoms, bb, psi, pairs, pin: PackInput):
    """chi_flat (B, 4L) -> (B,) over a fixed backbone (frames made once)."""
    def fun(chi_flat):
        chi = chi_flat.unflatten(-1, (-1, 4))
        xyz, _ = _atom14(bb, atoms, psi, chi, pin, True)
        return (W_CLASH * _clash_energy(xyz, pin)
                + W_ROTAMER * _rotamer_energy(chi, pin)
                + W_SS * _disulfide_energy(xyz, pairs, pin))
    return fun


def _pack(torsions, chi0, pairs, pin: PackInput, max_iter: int,
          backbone=None):
    """(B, 3, L) torsions + (B, L, 4) chi0 -> (packed atom14 (B, L, 14, 3),
    mask (L, 14), chi (B, L, 4), final energies (B,)). Its energy
    evaluations count in STATS.free_evals: they launch no spline kernel."""
    B, _, L = torsions.shape
    atoms, bb = _backbone(torsions, backbone)
    atoms = {k: v.detach() for k, v in atoms.items()}
    bb = type(bb)(*(t.detach() for t in bb))
    psi = torsions[:, 1].detach()
    with STATS.restraint_free():
        res = lbfgs_minimize(_pack_objective(atoms, bb, psi, pairs, pin),
                             chi0.reshape(B, L * 4), max_iter=max_iter)
    chi = res.x.reshape(B, L, 4)
    with torch.no_grad():
        xyz, mask = _atom14(bb, atoms, psi, chi, pin, True)
    return xyz, mask, chi, res.f


def pack_ensemble(torsions, seq: str, max_iter: int = 150,
                  pairs: Optional[np.ndarray] = None, backbone=None,
                  device="cuda"):
    """Pack sidechains for a (B, 3, L) torsion ensemble on `device`.

    Returns (atom14 (B, L, 14, 3), atom14_mask (L, 14), chi (B, L, 4)).
    Disulfide pairs are detected from the batch-mean CB positions unless
    given (the ensemble shares one pairing, as the reference's per-pose
    detection with one sequence). backbone: pack onto these N/CA/C/O/CB
    (B, L, 3) coordinates (the fold's cart-refined atoms) instead of the
    ideal NeRF build of the torsions."""
    dev = resolve_device(device)
    torsions = torch.as_tensor(torsions, dtype=torch.float32).to(dev)
    if torsions.dim() == 2:
        torsions = torsions[None]
    B, _, L = torsions.shape
    if backbone is not None:
        backbone = {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
                    for k, v in backbone.items()}
    pin = pack_input(seq, dev)
    if pairs is None:
        with torch.no_grad():
            atoms, _ = _backbone(torsions, backbone)
        pairs = detect_disulfides(atoms["CB"].mean(0).cpu().numpy(), seq)
    pairs = torch.as_tensor(np.asarray(pairs, np.int64).reshape(-1, 2),
                            device=dev)
    # staggered trans start for every chi
    chi0 = torch.full((B, L, 4), np.pi, dtype=torch.float32,
                      device=dev) * pin.chi_mask
    xyz, mask, chi, _ = _pack(torsions, chi0, pairs, pin, max_iter,
                              backbone)
    return xyz, mask, chi


def pack_and_write(paths, seq: str, torsions, max_iter: int = 150,
                   backbone=None, device="cuda") -> None:
    """Pack the ensemble's sidechains and write one full-atom PDB per decoy
    (the reference's pose.dump_pdb after FastRelax, folding.py:273).
    backbone: pack onto these (cart-refined) coordinates instead of the
    ideal NeRF build of the torsions."""
    from trx2dy_torch.io.pdbio import write_pdb_atom14

    xyz14, mask, _ = pack_ensemble(torsions, seq, max_iter=max_iter,
                                   backbone=backbone, device=device)
    xyz14 = xyz14.cpu().numpy()
    mask = mask.cpu().numpy()
    for b, path in enumerate(paths):
        write_pdb_atom14(path, seq, xyz14[b], mask)

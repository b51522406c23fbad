"""The Dynamics sampling step: decoy -> measured histograms -> dampened npz.

Port of trx2dy/dynamics/loop.py (reference utils_trX2dy/utils.py:406-475
get_npz_from_pred_pdb and run_inference.py:16-144). After each folded
decoy its realised geometry is binned into one-hot histograms, the
realised peaks of the current distributions are dampened, and the result
(renormalised and smoothed) feeds the next minimisation, beside an
unnormalised "tmp" channel whose largest change drives convergence.

As in JAX, the decoy is measured from its atoms in memory, not from a PDB
file, and its CB is the fold's (virtual) CB; the phi histogram bins theta
values (binning.phi_compat_bug, utils.py:226). Every function here takes
leading batch axes (the sampler's lanes) before the per-decoy ones.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from trx2dy_torch.dynamics.dampen import DampenParams, dampen_distribution
from trx2dy_torch.geometry.binning import bin_geometry_maps
from trx2dy_torch.geometry.transforms import geometry_maps_6d


class GeomHistograms(NamedTuple):
    """Geometry histograms and the convergence channel, each (..., L, L, n)."""
    dist: torch.Tensor    # 37 bins
    omega: torch.Tensor   # 25
    theta: torch.Tensor   # 25
    phi: torch.Tensor     # 13
    tmp: torch.Tensor     # 37, unnormalised


def histograms_from_npz(npz: dict, device="cpu") -> GeomHistograms:
    """Histograms of a reference-layout npz dict on `device`; 'tmp'
    defaults to 'dist' (utils.py:460-463)."""
    def g(k):
        return torch.as_tensor(np.asarray(npz[k], np.float32), device=device)
    return GeomHistograms(dist=g("dist"), omega=g("omega"), theta=g("theta"),
                          phi=g("phi"), tmp=g("tmp" if "tmp" in npz
                                              else "dist"))


def histograms_to_npz(h: GeomHistograms) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in h._asdict().items()}


def measure_decoy(n, ca, c, cb) -> dict:
    """One-hot float32 histograms (..., L, L, nbins) of decoys' realised
    geometry, atoms (..., L, 3): get_distribution_from_pdb
    (utils.py:294-316), a dense 20 A contact mask in place of the cKDTree,
    then the binning."""
    maps = geometry_maps_6d(n, ca, c, cb=cb, dmax=20.0)
    return bin_geometry_maps(maps["dist"], maps["omega"], maps["theta"],
                             maps["phi"], angle=True, phi_compat_bug=True)


def dampen_step(cur: GeomHistograms, fact: dict, sigma: float = 1.0,
                angle: bool = True,
                params: DampenParams = DampenParams()) -> GeomHistograms:
    """One Dynamics update (get_npz_from_pred_pdb, utils.py:406-475): each
    geometry dampened against its measured one-hot histograms with
    renormalisation and smoothing, tmp from the previous tmp without.
    As in JAX, the smoothing width is params.sigma; `sigma` is accepted
    for the caller's signature and not read."""
    new_dist = dampen_distribution(cur.dist, fact["dist"], params)
    new_tmp = dampen_distribution(cur.tmp, fact["dist"], params, norm=False)
    if angle:
        new_omega, new_theta, new_phi = (
            dampen_distribution(getattr(cur, k), fact[k], params)
            for k in ("omega", "theta", "phi"))
    else:
        new_omega, new_theta, new_phi = cur.omega, cur.theta, cur.phi
    return GeomHistograms(dist=new_dist, omega=new_omega, theta=new_theta,
                          phi=new_phi, tmp=new_tmp)


def reliability_score(torsions: torch.Tensor) -> torch.Tensor:
    """Ramachandran reliability (utils.py:337-372): the fraction of
    interior residues 1..L-2 with phi in [-180, 0]; torsions (..., 3, L)
    [phi; psi; omega] -> (...)."""
    phi = torsions[..., 0, :]
    L = phi.shape[-1]
    w = torch.remainder(phi + np.pi, 2.0 * np.pi) - np.pi
    ok = (w >= -np.pi) & (w <= 0.0)
    idx = torch.arange(L, device=phi.device)
    interior = (idx >= 1) & (idx <= L - 2)
    return torch.sum(ok & interior, dim=-1) / max(L - 2, 1)


def convergence_delta(old: GeomHistograms, new: GeomHistograms) -> float:
    """max |delta tmp|, the driver's convergence statistic
    (run_inference.py:135-137)."""
    return float(torch.max(torch.abs(old.tmp - new.tmp)))

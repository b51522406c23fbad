"""Histogram binning of real-valued 6D geometry maps.

Port of trx2dy/geometry/binning.py (the reference's per-structure loops,
utils_trX2dy/utils.py:185-249), with the same bin semantics:

  bin(x) = sum(edges < x), left-open intervals
  dist  : edges 2.0, 2.5, ..., 20.0 (37 edges) -> 37 bins; d<=2 or d>20 -> 0
  omega : edges -pi + k pi/12, k=0..23 -> 25 bins, 0 where the dist bin is 0
  theta : as omega
  phi   : edges k pi/12, k=0..11 -> 13 bins, 0 where the dist bin is 0

phi_compat_bug=True (the default) bins the theta values against the phi
edges, as the reference does (utils.py:226 `Tphi_asym =
theta_asym.reshape(...)`).
"""
from __future__ import annotations

import numpy as np
import torch

DIST_EDGES = np.arange(2.0, 20.5, 0.5)                   # 37 edges
TORSION_EDGES = np.arange(-np.pi, np.pi, np.pi / 12.0)   # 24 edges
PLANAR_EDGES = np.arange(0.0, np.pi, np.pi / 12.0)       # 12 edges

N_DIST_BINS = 37
N_TORSION_BINS = 25
N_PLANAR_BINS = 13


def _bin_index(x: torch.Tensor, edges: np.ndarray) -> torch.Tensor:
    """sum(edges < x), the edges in x's dtype."""
    e = torch.as_tensor(edges, dtype=x.dtype, device=x.device)
    return torch.sum(e < x[..., None], dim=-1)


def _one_hot(idx, n):
    return torch.nn.functional.one_hot(idx, n).to(torch.float32)


def bin_geometry_maps(dist, omega=None, theta=None, phi=None,
                      angle: bool = True, phi_compat_bug: bool = True):
    """One-hot float32 histograms of (L, L) real maps (0 outside the
    contact mask, as geometry_maps_6d makes them): dist (L, L, 37) and,
    with angle, omega and theta (L, L, 25) and phi (L, L, 13)."""
    jd = _bin_index(dist, DIST_EDGES)
    jd = torch.where(jd >= N_DIST_BINS, 0, jd)    # d > 20 -> no contact
    out = {"dist": _one_hot(jd, N_DIST_BINS)}
    if not angle:
        return out
    no_contact = jd == 0
    for key, src, edges, n in (
            ("omega", omega, TORSION_EDGES, N_TORSION_BINS),
            ("theta", theta, TORSION_EDGES, N_TORSION_BINS),
            ("phi", theta if phi_compat_bug else phi, PLANAR_EDGES,
             N_PLANAR_BINS)):
        j = torch.where(no_contact, 0, _bin_index(src, edges))
        out[key] = _one_hot(j, n)
    return out

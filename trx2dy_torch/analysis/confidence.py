"""Prediction-confidence estimates from distance histograms.

The port's own numpy copy of trx2dy/analysis/confidence.py (host code,
no device work).

Vectorized equivalents of folding/utils_ros/top_prob.py:

  top_dist (top_prob.py:35-68): mean over 9 distance super-bins of the mean
    max-super-bin probability among the top-15L |i-j| >= sep pairs ranked by
    total contact probability; plus the max normalized separation.
  top_cont (top_prob.py:23-31): mean contact probability (bins 1..12, i.e.
    < 8 A) of the top-L pairs.
  cscore (utils_ros.py:784-796, commented-out remnant): the published
    TM-score estimate combining both.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _ranked_pairs(weight: np.ndarray, separation: int):
    """Strictly-lower-triangle pairs with i - j >= separation (the
    reference enumerates i in [j+sep, L)), ranked by descending weight."""
    L = weight.shape[0]
    ii, jj = np.meshgrid(np.arange(L), np.arange(L), indexing="ij")
    sel = ii - jj >= separation
    i, j = ii[sel], jj[sel]
    order = np.argsort(weight[i, j])[::-1]
    return i[order], j[order]


def top_dist(dist: np.ndarray, separation: int = 12) -> Tuple[float, float]:
    """(mean top-distance probability, max separation / L)."""
    L = dist.shape[0]
    w = dist[:, :, 1:37].sum(-1)
    super_bins = np.stack([dist[:, :, 1 + 4 * k: 5 + 4 * k].sum(-1)
                           for k in range(9)], axis=-1)   # (L, L, 9)
    i, j = _ranked_pairs(w, separation)
    topn = min(15 * L, len(i))
    i, j = i[:topn], j[:topn]
    probs9 = super_bins[i, j]                              # (topn, 9)
    bins = probs9.argmax(-1)
    probs = probs9[np.arange(len(bins)), bins]
    means = [probs[bins == k].mean() for k in range(9)
             if (bins == k).any()]
    sepmax = np.abs(i - j).max() / L if len(i) else 0.0
    return round(float(np.mean(means)), 2), float(sepmax)


def top_cont(dist: np.ndarray, separation: int = 12) -> float:
    """Mean < 8 A contact probability of the top-L ranked pairs."""
    L = dist.shape[0]
    wc = dist[:, :, 1:13].sum(-1)
    i, j = _ranked_pairs(wc, separation)
    topn = min(L, len(i))
    return round(float(wc[i[:topn], j[:topn]].mean()), 2)


def cscore(dist: np.ndarray, has_good_template: bool = False) -> float:
    """Estimated TM-score of the top model (utils_ros.py:784-796)."""
    prob, sep = top_dist(dist, 12)
    if has_good_template:
        c = 0.9342 * prob + 0.2333 * sep + 0.0957
    else:
        c = 1.158 * prob + 0.1878 * sep + 0.0318
    return float(np.clip(c, 0.1, 1.0))

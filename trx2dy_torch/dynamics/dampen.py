"""Distribution dampening, the core of the Dynamics sampler.

Port of trx2dy/dynamics/dampen.py (the reference's per-pair loop,
utils_trX2dy/utils.py:325-403). After each decoy, the histogram peaks the
decoy realised are suppressed, pushing the next minimisation into other
modes of the predicted distributions:

  for pairs (i, j) with max_b pred[i, j, b] < P:
      k = argmax_b fact[i, j, b]          # the bin the decoy realised
      if pred[i, j, k] >= pcut: pred[i, j, k] *= decay_rate
      renormalise pred[i, j, :]; Gaussian-smooth (sigma 1) along the bins

Edge cases kept from the reference:
  * the window is the argmax bin alone (every published flag);
  * when the argmax is the last bin the reference's slice is empty
    (utils.py:392), so nothing decays, but renormalisation and smoothing
    still apply;
  * the unnormalised "tmp" channel (norm=False) skips renormalisation and
    smoothing and drives the driver's convergence check.

Every function takes histograms with any leading axes (a lane axis of the
batched sampler) before the (L, L, B) ones.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DampenParams(NamedTuple):
    """Sampling hyper-parameters (reference utils.py:325-334)."""
    P: float = 0.5          # only dampen pairs whose max probability is below
    pcut: float = 0.05      # only decay bins at or above this probability
    decay_rate: float = 0.5
    sigma: float = 1.0      # Gaussian smoothing along the bin axis


# the reference's flag table ("0HD" is the only flag it uses, utils.py:385)
DAMPEN_FLAGS = {
    "0HHD": DampenParams(P=0.3, pcut=0.03, decay_rate=0.72),
    "0LD": DampenParams(P=0.5, pcut=0.07, decay_rate=0.50),
    "0HD": DampenParams(P=0.5, pcut=0.05, decay_rate=0.50),
    "0LLD": DampenParams(P=0.7, pcut=0.1, decay_rate=0.42),
}


def gaussian_smooth_bins(x: torch.Tensor, sigma: float = 1.0,
                         truncate: float = 4.0) -> torch.Tensor:
    """1D Gaussian filter along the last axis, as
    scipy.ndimage.gaussian_filter(mode='reflect', truncate=4.0) applies it
    to each bin vector (utils.py:375-376,399). scipy's 'reflect' repeats
    the edge value (numpy's 'symmetric' pad)."""
    radius = int(truncate * sigma + 0.5)
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    kernel = np.exp(-0.5 * (t / sigma) ** 2)
    kernel = (kernel / kernel.sum()).astype(np.float32)
    n = x.shape[-1]
    src = np.pad(np.arange(n), radius, mode="symmetric")
    xp = x.index_select(-1, torch.as_tensor(src, device=x.device))
    out = 0
    for i, k in enumerate(kernel.tolist()):     # JAX's order of the sum
        out = out + xp[..., i:i + n] * k
    return out


def dampen_distribution(pred: torch.Tensor, fact: torch.Tensor,
                        params: DampenParams = DampenParams(),
                        norm: bool = True,
                        smooth: bool = True) -> torch.Tensor:
    """Dampen histograms pred (..., L, L, B) against a decoy's realised
    one-hot bins fact of the same shape. norm=True renormalises and (with
    smooth) smooths the dampened pairs; norm=False returns the raw decayed
    histograms (the tmp convergence channel)."""
    B = pred.shape[-1]
    mask = torch.amax(pred, dim=-1) < params.P
    idx = torch.argmax(fact, dim=-1)
    val = torch.gather(pred, -1, idx[..., None])[..., 0]
    do_decay = mask & (val >= params.pcut) & (idx != B - 1)
    onehot = torch.nn.functional.one_hot(idx, B).bool()
    decayed = pred * torch.where(onehot & do_decay[..., None],
                                 params.decay_rate, 1.0)
    if not norm:
        return decayed
    ssum = torch.sum(decayed, dim=-1, keepdim=True)
    normalized = decayed / torch.where(ssum == 0, 1.0, ssum)
    if smooth:
        normalized = gaussian_smooth_bins(normalized, params.sigma)
    # only dampened pairs are renormalised and smoothed
    return torch.where(mask[..., None], normalized, pred)

"""The train CLI's step in plain PyTorch: labels, loss, clip, AdamW.

Follows the port's models/dataset.py and models/train.py (as of the
benchmark's first version) and optax's semantics, written out by hand:

- labels: the bins of the native's 6D geometry maps (dist 37 with bin 0 =
  no contact, omega/theta 25, phi 13 from the real phi), residues missing
  N, CA or C masked out, the virtual CB where the real one is absent;
- loss: the masked mean cross-entropy of the four heads, summed over the
  heads, through the plain Predictor2D (the logits attention);
- update: optax.chain(clip_by_global_norm(clip), adamw(lr, weight_decay)),
  b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected, the
  decay decoupled and applied to every parameter.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from plainref.binning import bin_geometry_maps
from plainref.transforms import geometry_maps_6d, virtual_cb

HEAD_BINS = {"dist": 37, "omega": 25, "theta": 25, "phi": 13}
BETAS = (0.9, 0.999)
EPS = 1e-8


def labels_from_structure(coords: Dict[str, np.ndarray]):
    """(bin-index labels {head: (L, L) int64}, (L, L) bool mask) of a
    backbone {N, CA, C[, CB]: (L, 3)}, computed in float32 on the CPU."""
    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32)
    n, ca, c = (np.asarray(coords[a]) for a in ("N", "CA", "C"))
    ok = ~(np.isnan(n).any(-1) | np.isnan(ca).any(-1) | np.isnan(c).any(-1))
    n, ca, c = (np.nan_to_num(x) for x in (n, ca, c))
    vcb = virtual_cb(f32(n), f32(ca), f32(c)).numpy()
    cb = coords.get("CB")
    cb = vcb if cb is None else np.where(
        np.isnan(np.asarray(cb)).any(-1, keepdims=True), vcb, cb)
    maps = geometry_maps_6d(f32(n), f32(ca), f32(c), cb=f32(cb),
                            atom_mask=torch.as_tensor(ok))
    hist = bin_geometry_maps(maps["dist"], maps["omega"], maps["theta"],
                             maps["phi"], angle=True, phi_compat_bug=False)
    labels = {k: v.argmax(-1).long() for k, v in hist.items()}
    return labels, torch.as_tensor(ok[:, None] & ok[None, :])


def geometry_loss(model, f2d, msa, labels, mask,
                  remat: bool = False) -> torch.Tensor:
    """Masked mean cross-entropy over the four heads for one sample (remat:
    each trunk block recomputed in the backward pass, to fit)."""
    logits = model(f2d, msa, remat=remat)
    count = mask.sum().clamp(min=1)
    total = torch.zeros((), device=f2d.device)
    for k in HEAD_BINS:
        logp = F.log_softmax(logits[k], dim=-1)
        nll = -logp.gather(-1, labels[k][..., None].long())[..., 0]
        total = total + torch.where(mask, nll, 0.0).sum() / count
    return total


class AdamW:
    """clip_by_global_norm then AdamW, on a list of parameters."""

    def __init__(self, params, lr: float = 1e-3, weight_decay: float = 1e-4,
                 clip: float = 1.0):
        self.params = list(params)
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> list:
        """One update from the parameters' .grad (None counts as zero);
        returns the clipped gradients the moments took."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        scale = 1.0 if norm < self.clip else float(self.clip / norm)
        grads = [g * scale for g in grads]
        self.count += 1
        b1, b2 = BETAS
        c1, c2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            upd = (m / c1) / (torch.sqrt(v / c2) + EPS) + self.wd * p
            p.sub_(self.lr * upd)
        return grads

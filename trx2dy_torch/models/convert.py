"""Weights for the port's Predictor2D: load, carry over, make at random.

The pretrained checkpoints (trX2(NMR)_40.pth, trX2(X-ray)_40.pth) are
plain state_dicts whose keys sit under `net.`, and the JAX package's flat
param dicts use those same keys. So carrying weights over is a cast only:
the keys stay the same and conv weights stay OIHW.

Loading raises on a missing key and ignores (and lists) an extra one: a
published checkpoint can hold modules that are defined but never run, such
as UpdateX's norm and conv layers, which the JAX package also never reads.
"""
from __future__ import annotations

import logging
import re
from typing import Dict, List, Mapping

import numpy as np
import torch

from trx2dy_torch.models.predictor2d import DEPTH, DistPredictor

log = logging.getLogger(__name__)

_BLOCK_RE = re.compile(r"^net\.net\.blocks\.(\d+)\.")


def state_dict_from_flat(params: Mapping[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """The port's state_dict from a flat {checkpoint key: array} dict."""
    return {k: torch.as_tensor(np.asarray(v, dtype=np.float32))
            for k, v in params.items()}


def load_params(path: str) -> Dict[str, np.ndarray]:
    """Flat float32 params from a `.pth` state_dict or a `.npz`."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return {k: np.asarray(f[k], dtype=np.float32) for k in f.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):       # whole-module checkpoint
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in sd.items()}


def depth_of(keys) -> int:
    """Number of trunk blocks named in a checkpoint's keys."""
    idx = [int(m.group(1)) for k in keys if (m := _BLOCK_RE.match(k))]
    if not idx:
        raise KeyError("no net.net.blocks.* keys: not a Predictor2D checkpoint")
    return max(idx) + 1


def load_into(model: torch.nn.Module, state: Mapping[str, torch.Tensor]
              ) -> List[str]:
    """Copy `state` into `model`; raise on a missing key, ignore and return
    the extra ones."""
    want = model.state_dict().keys()
    missing = sorted(set(want) - set(state))
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys, e.g. "
                       f"{missing[:5]}")
    extra = sorted(set(state) - set(want))
    if extra:
        log.info("ignoring %d checkpoint keys the model does not read: %s",
                 len(extra), extra)
    model.load_state_dict({k: state[k] for k in want}, strict=True)
    return extra


def build_model(params: Mapping[str, np.ndarray], device) -> DistPredictor:
    """A DistPredictor in eval mode on `device`, depth taken from the keys."""
    state = state_dict_from_flat(params)
    with torch.device("meta"):
        model = DistPredictor(depth=depth_of(state))
    model = model.to_empty(device=device)
    load_into(model, state)
    return model.eval()


def param_shapes(depth: int = DEPTH) -> Dict[str, tuple]:
    """Checkpoint key -> shape of the port's Predictor2D at `depth`."""
    with torch.device("meta"):
        model = DistPredictor(depth=depth)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def init_state_dict(seed: int, depth: int = DEPTH) -> Dict[str, np.ndarray]:
    """Seeded random weights with the checkpoint's keys and shapes.

    Matrices and kernels are normal / sqrt(fan_in). Unlike the JAX
    package's init_params, biases get 0.1-scale noise and 1-D norm weights
    1 + 0.1-scale noise, so a dropped bias or norm affine shows in every
    comparison."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in sorted(param_shapes(depth).items()):
        noise = rng.standard_normal(shape).astype(np.float32)
        if len(shape) > 1:
            out[name] = noise / np.float32(np.sqrt(np.prod(shape[1:])))
        elif name.endswith(".bias"):
            out[name] = np.float32(0.1) * noise
        else:
            out[name] = np.float32(1.0) + np.float32(0.1) * noise
    return out

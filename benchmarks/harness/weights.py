"""Seeded random weights, made on the device in one draw.

The draw follows the port's init_state_dict convention (matrices and
kernels normal / sqrt(fan_in), biases 0.1-scale noise, other 1-D tensors
1 + 0.1-scale noise, so that a dropped bias or norm affine shows) but is
the benchmark's own: one torch.Generator on the device, one normal draw
for the whole model, split by key in sorted order. With a serving
dtype, the matrices are made in it and norms, biases and other 1-D
tensors stay float32 (the e2e predictor's --bf16 rule).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def sub_seed(seed: int, *path) -> int:
    """A 63-bit seed for one part of a run, from the run's seed and a
    path of strings or integers."""
    words = [int(seed)] + [int.from_bytes(str(p).encode(), "little")
                           % (2 ** 32) for p in path]
    return int(np.random.SeedSequence(words).generate_state(
        2, np.uint32).view(np.uint64)[0] >> np.uint64(1))


def is_matrix(key: str, shape: tuple) -> bool:
    """Whether a tensor is served in the reduced dtype: more than one
    axis and not a norm's affine (convert.cast_params' rule)."""
    parts = key.split(".")
    is_norm = ((".norm" in key or "bn" in parts[-2])
               if len(parts) > 1 else False) \
        or key.endswith("layer_norm.weight") or key.endswith("layer_norm.bias")
    return len(shape) > 1 and not is_norm


def shapes_of(model: torch.nn.Module) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


ALIGN = 64   # elements: every tensor starts on a 256-byte boundary


def seeded_state(shapes: Mapping[str, tuple], seed: int, device,
                 serve_dtype: Optional[torch.dtype] = None,
                 gain: float = 1.0) -> Dict[str, torch.Tensor]:
    """{key: tensor on `device`} for every key of `shapes`; the matrices'
    spread is `gain` / sqrt(fan_in). The tensors are views into one or
    two flat buffers, made by a handful of whole-model calls; each starts
    on an aligned offset (a builder that takes the tensors as they are
    would otherwise run its products on unaligned weights)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    keys = sorted(shapes)
    sizes = [int(np.prod(shapes[k])) for k in keys]
    padded = [-(-n // ALIGN) * ALIGN for n in sizes]
    scale, offset = [], []
    for k in keys:
        shape = shapes[k]
        if len(shape) > 1:
            scale.append(gain / np.sqrt(np.prod(shape[1:])))
            offset.append(0.0)
        else:
            scale.append(0.1)
            offset.append(0.0 if k.endswith(".bias") else 1.0)
    total = sum(padded)
    per = torch.as_tensor(np.stack([scale, offset]), dtype=torch.float32,
                          device=device)
    spread = torch.repeat_interleave(
        per, torch.as_tensor(padded, device=device), dim=1,
        output_size=total)
    flat = torch.randn(total, generator=gen, device=device) * spread[0] \
        + spread[1]
    served = flat.to(serve_dtype) if serve_dtype is not None else flat
    out, start = {}, 0
    for key, n, step in zip(keys, sizes, padded):
        shape = shapes[key]
        src = served if serve_dtype is not None and is_matrix(key, shape) \
            else flat
        out[key] = src[start:start + n].view(shape)
        start += step
    return out


def upcast(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A float32 copy of a state dict (the reference's)."""
    return {k: v.detach().float().clone() for k, v in state.items()}

"""The products of the plain reference, and the control's lower precision.

Every matrix product of the reference (linear layers, convolutions,
einsums, matmuls) goes through this module. By default they run in the
reference's own precision: float32 with TF32 off (the benchmark switches
TF32 off before it runs the reference). Inside `precision("tf32")` or
`precision("fp8")` each product's two inputs are first rounded to that
format, and the product accumulates in float32 as the hardware's would:

- tf32: 10 explicit mantissa bits, rounded to nearest with ties away
  from zero (the conversion NVIDIA's TF32 tensor-core path applies);
- fp8: float8_e4m3fn with one scale per tensor, amax / 448 (an fp8 GEMM
  with current scaling).

That is the control of `correct`: the reference put in the program's
place and computed one precision below the configuration's. The rounding
is emulated, so the control computes the same function on the CPU and on
the card.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_MODE = [None]
FP8_MAX = 448.0
# the control's precision, one below each configuration's
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


@contextlib.contextmanager
def precision(mode):
    """Run the reference's products with inputs rounded to `mode` (None,
    "tf32" or "fp8")."""
    if mode not in (None, "tf32", "fp8"):
        raise ValueError(f"unknown control precision {mode!r}")
    old, _MODE[0] = _MODE[0], mode
    try:
        yield
    finally:
        _MODE[0] = old


def _round(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "tf32":
        bits = x.view(torch.int32)
        # add half an ulp of the 13 dropped bits to the magnitude, then drop
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def rnd(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the current mode's format, returned in float32. The
    gradient passes the rounding unchanged, so in a backward pass only
    the forward inputs that a product saved are rounded, not the output
    gradient: the control's backward is closer to float32 than TF32's."""
    mode = _MODE[0]
    if mode is None or not x.is_floating_point():
        return x
    x = x.float()
    with torch.no_grad():
        q = _round(x.detach().contiguous(), mode)
    return x + (q - x).detach() if x.requires_grad else q


def einsum(eq: str, *ops):
    return torch.einsum(eq, *(rnd(o) for o in ops))


def matmul(a, b):
    return torch.matmul(rnd(a), rnd(b))


def linear(x, w, b=None):
    return F.linear(rnd(x), rnd(w), b)


def conv2d(x, w, b=None, padding=0):
    return F.conv2d(rnd(x), rnd(w), b, padding=padding)

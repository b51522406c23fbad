"""Device selection for the port's entry points.

Entry points take `device`, defaulting to "cuda". Asking for CUDA where
there is none raises: no path carries on on the CPU unless the caller
passed device="cpu".
"""
from __future__ import annotations

import time
from typing import Optional

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`, with float32 products kept exact.

    The JAX package pins Precision.HIGHEST on its products
    (trx2dy/models/predictor2d.py:41, features.py:52), and reweight's
    identity counts are exact integers only without TF32, so TF32 is
    switched off for matmuls and cuDNN convolutions alike, and bf16
    products (the e2e predictor's bf16 weights) accumulate in float32
    without reduced-precision reductions.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


class StageTimer:
    """Appends (stage, host seconds since the previous stage) to a list,
    after syncing the device so that each stage holds its own device work.
    Without a list it does nothing, and syncs nothing."""

    def __init__(self, timings: Optional[list], device):
        self.timings, self.device = timings, torch.device(device)
        self.t = time.perf_counter()

    def __call__(self, stage: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings.append((stage, now - self.t))
        self.t = now

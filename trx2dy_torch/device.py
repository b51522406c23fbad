"""Device selection for the port's entry points.

Entry points take `device`, defaulting to "cuda". Asking for CUDA where
there is none raises: no path carries on on the CPU unless the caller
passed device="cpu".
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`, with float32 products kept exact.

    The JAX package pins Precision.HIGHEST on its products
    (trx2dy/models/predictor2d.py:41, features.py:52), and reweight's
    identity counts are exact integers only without TF32, so TF32 is
    switched off for matmuls and cuDNN convolutions alike.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev

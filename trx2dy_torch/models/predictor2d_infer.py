"""2D-geometry inference: a3m -> features -> Predictor2D -> softmaxed
histograms npz (utils_trX2dy/utils.py:768-797 pred_2d_geometry).

Weights come from the original `.pth` or from an `.npz` with the same keys.
On a CUDA device every triangle attention goes through the CUDA kernel, at
every L; on the CPU it takes the plain version.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from trx2dy_torch.device import resolve_device
from trx2dy_torch.io.a3m import parse_a3m
from trx2dy_torch.models.convert import build_model, load_params
from trx2dy_torch.models.features import get_f2d
from trx2dy_torch.parallel.mesh import axis, shard
from trx2dy_torch.utils.profiling import span

MSA_CUTOFF = 500      # trunk row cap (utils.py:635)
PARSE_LIMIT = 20000   # a3m row cap (utils.py:733)


def read_msa(msa_file: str) -> np.ndarray:
    """(R, L) tokens from an `.a3m`, or from an `.npz` with an `msa` key
    (a leading batch axis of a 3-D array is dropped)."""
    if msa_file.endswith(".a3m"):
        return parse_a3m(msa_file, limit=PARSE_LIMIT)
    if msa_file.endswith(".npz"):
        with np.load(msa_file) as f:
            msa = f["msa"]
        return msa[0] if msa.ndim == 3 else msa
    raise ValueError(f"unsupported MSA file {msa_file!r}")


@torch.inference_mode()
def predict_geometry(model: torch.nn.Module, msa: np.ndarray,
                     mesh=None) -> Dict[str, np.ndarray]:
    """Softmaxed geometry histograms for an (R, L) token MSA, computed on
    the device that holds `model`. mesh: a (dp, mp) DeviceMesh
    (parallel/mesh.py) whose mp axis splits the trunk's rows; every rank
    passes the whole MSA and gets the whole histograms."""
    with span("geometry"):
        dev = next(model.parameters()).device
        tokens = torch.as_tensor(np.asarray(msa, dtype=np.int64),
                                 device=dev)
        f2d = get_f2d(tokens)
        logits = model(f2d, shard(tokens[:MSA_CUTOFF], mesh, "mp"),
                       mp=axis(mesh, "mp")[0])
        with span("output"):
            return {k: torch.softmax(v, dim=-1).cpu().numpy()
                    for k, v in logits.items()}


def pred_2d_geometry(weight_file: str, msa_file: str,
                     save_dir: Optional[str] = None,
                     save_name: Optional[str] = None,
                     device="cuda") -> Dict[str, np.ndarray]:
    """Load weights, read the MSA, predict, and save `<save_dir>/<save_name>
    .npz` with keys dist, omega, theta, phi when save_dir is given."""
    dev = resolve_device(device)
    model = build_model(load_params(weight_file), dev)
    labels = predict_geometry(model, read_msa(msa_file))
    if save_dir is not None:
        np.savez_compressed(os.path.join(save_dir, save_name), **labels)
    return labels

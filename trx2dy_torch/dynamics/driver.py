"""The geometry stage of the Dynamics pipeline (run_inference.py:280-337
run_single): the two softmaxed 2D-geometry npz files the sampler reads.

For each model tag, in priority order, the stage
  1. reuses an existing <save_dir>/<name>/pred_npz/<name>_<tag>.npz,
  2. copies <npz_dir>/<name>_<tag>.npz there,
  3. runs Predictor2D with the tag's weight file from model_dir.
The rest of run_single (folder, sampler) is not ported yet.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

from trx2dy_torch.device import resolve_device
from trx2dy_torch.models.predictor2d_infer import pred_2d_geometry

WEIGHT_FILES = {"NMR": "trX2(NMR)_40.pth", "Xray": "trX2(X-ray)_40.pth"}


def geometry_npz(name: str, tag: str, msa_file: Optional[str],
                 save_npz_dir: str, npz_dir: Optional[str] = None,
                 model_dir: Optional[str] = None, device="cuda") -> str:
    """Path of <save_npz_dir>/<name>_<tag>.npz, made if it is missing."""
    target = os.path.join(save_npz_dir, f"{name}_{tag}.npz")
    if os.path.exists(target):
        return target
    if npz_dir:
        src = os.path.join(npz_dir, f"{name}_{tag}.npz")
        if os.path.exists(src):
            shutil.copy(src, target)
            return target
    if model_dir is None:
        raise FileNotFoundError(
            f"no precomputed npz for {name}_{tag} and no model_dir given")
    pred_2d_geometry(os.path.join(model_dir, WEIGHT_FILES[tag]), msa_file,
                     save_npz_dir, f"{name}_{tag}", device=device)
    return target


def geometry_stage(name: str, msa_file: Optional[str], save_dir: str,
                   npz_dir: Optional[str] = None,
                   model_dir: Optional[str] = None,
                   device="cuda") -> Dict[str, str]:
    """{tag: npz path} under <save_dir>/<name>/pred_npz for both models."""
    dev = resolve_device(device)
    save_npz_dir = os.path.join(save_dir, name, "pred_npz")
    os.makedirs(save_npz_dir, exist_ok=True)
    return {tag: geometry_npz(name, tag, msa_file, save_npz_dir, npz_dir,
                              model_dir, dev)
            for tag in WEIGHT_FILES}

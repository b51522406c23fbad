"""Rules of the PyTorch port that no parity test shows.

- Nothing in trx2dy_torch/ or chip_smoke.py imports jax or trx2dy.
- Entry points default to CUDA and raise where there is none, rather than
  carrying on on the CPU; they switch TF32 off.
- chip_smoke.py fails, printing no result, without a CUDA device and in a
  directory that holds nothing else of the repo.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from trx2dy_torch.cli import fold as fold_cli
from trx2dy_torch.device import resolve_device
from trx2dy_torch.dynamics.driver import geometry_stage
from trx2dy_torch.models.predictor2d_infer import pred_2d_geometry
from trx2dy_torch.physics.folder import fold_ensemble

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "trx2dy_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_nor_jax_package(path):
    bad = {"jax", "jaxlib", "trx2dy"} & set(_imported_roots(path))
    assert not bad, f"{path} imports {bad}"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pred_2d_geometry("w.pth", "t.a3m")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        geometry_stage("tgt", None, str(tmp_path))
    assert not (tmp_path / "tgt").exists()


def test_fold_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    npz = {"dist": np.full((4, 4, 37), 1.0 / 37, np.float32)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fold_ensemble(npz, "AAAA", None, fastrelax=False, use_orient=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fold_cli.main(["-NPZ", str(tmp_path / "missing.npz"), "-FASTA",
                       str(tmp_path / "missing.fasta"), "-OUT",
                       str(tmp_path / "d.pdb"), "--no-fastrelax"])
    assert not (tmp_path / "d.pdb").exists()


def test_resolve_device_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _run_smoke(cwd: Path, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_cuda():
    # hide any card, so the script must refuse to run wherever this test runs
    res = _run_smoke(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout

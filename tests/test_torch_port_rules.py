"""Rules of the PyTorch port that no parity test shows.

- Nothing in trx2dy_torch/ or chip_smoke.py imports jax or trx2dy.
- Entry points (the geometry stage, the fold, the chain fold, packing,
  run_single, the analysis layer and the CLIs) default to CUDA and raise
  where there is none, before writing anything, rather than carrying on on
  the CPU; they switch TF32 off.
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

from trx2dy_torch.analysis import cluster, evaluate, tmscore
from trx2dy_torch.cli import cluster as cluster_cli
from trx2dy_torch.cli import evaluate as evaluate_cli
from trx2dy_torch.cli import fold as fold_cli
from trx2dy_torch.cli import run_inference as run_inference_cli
from trx2dy_torch.device import resolve_device
from trx2dy_torch.dynamics.driver import (
    DynamicsConfig, geometry_stage, run_single,
)
from trx2dy_torch.models.predictor2d_infer import pred_2d_geometry
from trx2dy_torch.physics.folder import fold_chains, fold_ensemble
from trx2dy_torch.physics.sidechain import pack_ensemble

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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pack_ensemble(np.zeros((1, 3, 4), np.float32), "AAAA")


def test_pipeline_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """run_single and the run_inference CLI refuse before any work: nothing
    is written under the save directory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fasta = tmp_path / "t.fasta"
    fasta.write_text(">t\nAAAA\n")
    save = tmp_path / "out"
    save.mkdir()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_single("t", str(fasta), None, str(save), DynamicsConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_inference_cli.main(["--fasta", str(fasta), "--msa",
                                str(tmp_path / "t.a3m"), "--name", "t",
                                "--save_dir", str(save), "--model_dir",
                                str(tmp_path / "models")])
    assert list(save.iterdir()) == []


def test_analysis_and_chain_fold_entry_points_raise_without_cuda(
        monkeypatch, tmp_path):
    """The TM-score engine, evaluation, clustering, their CLIs and
    fold_chains refuse before any work: no output directory is made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((6, 3), np.float32)
    d = str(tmp_path)
    calls = [
        lambda: tmscore.tm_score_pair(x, x),
        lambda: tmscore.tm_score_batch(x[None], x),
        lambda: evaluate.run_score(d, d, save_summary=True),
        lambda: cluster.decoy_dist_maps(d),
        lambda: cluster.tmscore_rmsd_matrices(d),
        lambda: cluster.save_cluster_result(d, output_dir=d + "/c"),
        lambda: evaluate_cli.main(["-n", d, "-p", d, "-o", d + "/e"]),
        lambda: cluster_cli.main(["-d", d, "-o", d + "/c"]),
        lambda: fold_chains([{"dist": np.full((4, 4, 37), 1.0 / 37,
                                              np.float32)}], "AAAA",
                            fastrelax=False, use_orient=False),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert list(tmp_path.iterdir()) == []


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

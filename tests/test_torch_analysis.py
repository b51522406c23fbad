"""The port's analysis layer (distance maps, glocon, clustering, evaluation,
confidence, the evaluate and cluster CLIs) against the JAX package, on the
CPU.

Decoys are backbones built by the port's NeRF from seeded torsions in
well-separated families (helix, strand, polyproline) and written by the
port's pdbio; GLY residues take the virtual CB. Distance maps and glocon
matrices agree within 1e-5, TM and RMSD matrices within 1e-5, cluster
labels, copied files, summary.txt and the confidence estimates exactly.
"""
import os
import sys

import numpy as np
import pytest
import torch

from trx2dy.analysis import cluster as jcluster
from trx2dy.analysis import confidence as jconf
from trx2dy.analysis import evaluate as jevaluate
from trx2dy.cli import cluster as jcluster_cli
from trx2dy.cli import evaluate as jevaluate_cli
from trx2dy_torch.analysis import cluster as tcluster
from trx2dy_torch.analysis import confidence as tconf
from trx2dy_torch.analysis import evaluate as tevaluate
from trx2dy_torch.cli import cluster as tcluster_cli
from trx2dy_torch.cli import evaluate as tevaluate_cli
from trx2dy_torch.geometry.nerf import build_backbone
from trx2dy_torch.io.pdbio import write_pdb_backbone

torch.set_num_threads(2)

L = 24
SEQ = "ARNDCQEGHILKMFPSTWYVARNG"
FAMILIES = ((-57.0, -47.0), (-120.0, 130.0), (-75.0, 145.0))   # degrees
TOL = 1e-5


def _decoys(n_per_family, L=L, seed=0, families=FAMILIES):
    """{atom: (N, L, 3)} backbones, n_per_family decoys of each family
    with 8 degrees of torsion noise."""
    rng = np.random.default_rng(seed)
    tors = []
    for phi, psi in families:
        for _ in range(n_per_family):
            t = np.deg2rad(np.stack([np.full(L, phi), np.full(L, psi),
                                     np.full(L, 180.0)])
                           + rng.normal(scale=8.0, size=(3, L)) * [[1], [1],
                                                                  [0.2]])
            tors.append(t)
    t = torch.as_tensor(np.stack(tors), dtype=torch.float32)
    atoms = build_backbone(t[:, 0], t[:, 1], t[:, 2])
    return {k: v.numpy() for k, v in atoms.items()}


def _write(dirpath, atoms, seq=SEQ, names=None, renumber=None):
    """One PDB per decoy; renumber maps residue index -> residue number
    (None drops the residue)."""
    os.makedirs(dirpath, exist_ok=True)
    n = len(atoms["CA"])
    names = names or [f"d{k}.pdb" for k in range(n)]
    for k, name in enumerate(names):
        path = os.path.join(dirpath, name)
        write_pdb_backbone(path, seq, {a: v[k] for a, v in atoms.items()})
        if renumber is not None:
            lines = []
            with open(path) as f:
                for ln in f:
                    if ln.startswith("ATOM"):
                        num = renumber(int(ln[22:26]) - 1)
                        if num is None:
                            continue
                        ln = ln[:22] + f"{num:4d}" + ln[26:]
                    lines.append(ln)
            with open(path, "w") as f:
                f.writelines(lines)
    return names


@pytest.fixture(scope="module")
def decoy_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("decoys")
    _write(str(d), _decoys(3))
    return str(d)


def test_dist_maps_and_glocon_match_jax(decoy_dir):
    maps, files = tcluster.decoy_dist_maps(decoy_dir, device="cpu")
    ref, ref_files = jcluster.decoy_dist_maps(decoy_dir)
    assert files == ref_files and maps.shape == (9, L, L)
    assert np.abs(maps - ref).max() < TOL
    got = tcluster.glocon_matrix_from_maps(torch.as_tensor(maps)).numpy()
    want = np.asarray(jcluster.glocon_matrix_from_maps(ref))
    assert np.abs(got - want).max() < TOL * max(1.0, np.abs(want).max())


def test_glocon_row_blocks_are_exact(decoy_dir, monkeypatch):
    """The row-blocked reduction gives the unblocked result to the bit."""
    maps = torch.as_tensor(tcluster.decoy_dist_maps(decoy_dir, "cpu")[0])
    whole = tcluster.glocon_matrix_from_maps(maps)
    monkeypatch.setattr(tcluster, "GLOCON_BLOCK_ELEMS", 2 * 9 * L * L)
    assert torch.equal(tcluster.glocon_matrix_from_maps(maps), whole)


@pytest.mark.parametrize("mode", ["glocon", "tmscore", "rmsd"])
def test_cluster_labels_match_jax(decoy_dir, mode):
    got = tcluster.cluster_decoys(decoy_dir, n_clusters=3, mode=mode,
                                  device="cpu")
    ref = jcluster.cluster_decoys(decoy_dir, n_clusters=3, mode=mode)
    assert got == ref
    assert sorted(len(v) for v in got.values()) == [3, 3, 3]


def test_kmeans_without_sklearn_matches_jax(monkeypatch):
    """Where sklearn is absent (the GPU machine) both packages take their
    numpy k-means: the same labels; too few rows raise ValueError, which
    save_cluster_result turns into 'no_cluster'."""
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    rng = np.random.default_rng(4)
    m = np.concatenate([rng.normal(c, 0.3, (8, 5)) for c in (0.0, 3.0, 6.0)])
    got, ref = tcluster._kmeans(m, 3), jcluster._kmeans(m, 3)
    np.testing.assert_array_equal(got, ref)
    assert sorted(np.bincount(got)) == [8, 8, 8]
    with pytest.raises(ValueError):
        tcluster._kmeans(m[:2], 3)


def test_mixed_length_matrices_match_jax(tmp_path):
    """Decoys of two lengths take the device engine pair by pair, each pair
    on its anchored common residues."""
    atoms = _decoys(1, families=FAMILIES[:2])
    _write(str(tmp_path), atoms)
    short = {k: v[:1, 2:22] for k, v in _decoys(1, seed=5,
                                                 families=FAMILIES[:1]).items()}
    _write(str(tmp_path), short, seq=SEQ[2:22], names=["short.pdb"])
    got = tcluster.tmscore_rmsd_matrices(str(tmp_path), device="cpu")
    ref = jcluster.tmscore_rmsd_matrices(str(tmp_path))
    assert got[2] == ref[2]
    for g, r in zip(got[:2], ref[:2]):
        assert np.abs(g - r).max() < TOL


def test_save_cluster_result_no_cluster(tmp_path, decoy_dir):
    """More clusters than decoys: 'no_cluster' and nothing copied."""
    for pkg, kw in ((tcluster, {"device": "cpu"}), (jcluster, {})):
        out = tmp_path / pkg.__name__.split(".")[0]
        assert pkg.save_cluster_result(decoy_dir, n_clusters=12,
                                       output_dir=str(out),
                                       **kw) == "no_cluster"
        assert out.is_dir() and not any(out.iterdir())


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    """natives/: two decoys of the helix and strand families, one numbered
    from 5 with a gap after residue 12, one missing residues 3-5; preds/:
    six decoys numbered 1..L, and one of 20 residues (another bucket)."""
    root = tmp_path_factory.mktemp("eval")
    nat = _decoys(1, seed=11, families=FAMILIES[:2])
    _write(str(root / "natives"), {k: v[:1] for k, v in nat.items()},
           names=["apo.pdb"],
           renumber=lambda i: i + 5 if i < 12 else i + 8)
    _write(str(root / "natives"), {k: v[1:] for k, v in nat.items()},
           names=["holo.pdb"],
           renumber=lambda i: None if 2 <= i <= 4 else i + 1)
    _write(str(root / "preds"), _decoys(2, seed=12),
           names=[f"conf_{m}_{k}.pdb" for m in (1, 2) for k in (1, 2, 3)])
    short = {k: v[:1, :20] for k, v in _decoys(1, seed=13).items()}
    _write(str(root / "preds"), short, seq=SEQ[:20], names=["conf_3_1.pdb"])
    return root


@pytest.mark.parametrize("align", [False, True], ids=["resseq", "align"])
def test_run_score_summary_byte_identical(eval_dirs, tmp_path, align):
    nat, pred = str(eval_dirs / "natives"), str(eval_dirs / "preds")
    got = tevaluate.run_score(nat, pred, align=align, save_summary=True,
                              save_dir=str(tmp_path / "port"), device="cpu")
    ref = jevaluate.run_score(nat, pred, align=align, save_summary=True,
                              save_dir=str(tmp_path / "jax"))
    text = (tmp_path / "port" / "summary.txt").read_bytes()
    assert text == (tmp_path / "jax" / "summary.txt").read_bytes()
    lines = text.decode().splitlines()
    assert [ln.split()[0] for ln in lines[:2]] == ["apo", "holo"]
    assert len(lines) == 6 and lines[-1].startswith("Max TM-score: ")
    assert np.abs(np.subtract(got, ref)).max() < TOL


def test_confidence_matches_jax():
    rng = np.random.default_rng(3)
    dist = rng.random((40, 40, 37)) ** 4
    dist /= dist.sum(-1, keepdims=True)
    for sep in (6, 12):
        assert tconf.top_dist(dist, sep) == jconf.top_dist(dist, sep)
        assert tconf.top_cont(dist, sep) == jconf.top_cont(dist, sep)
    for good in (False, True):
        assert tconf.cscore(dist, good) == jconf.cscore(dist, good)


def test_evaluate_cli_writes_what_jax_writes(eval_dirs, tmp_path, capsys):
    nat, pred = str(eval_dirs / "natives"), str(eval_dirs / "preds")
    tevaluate_cli.main(["-n", nat, "-p", pred, "-o",
                        str(tmp_path / "port" / "s.txt"), "--device", "cpu"])
    out = capsys.readouterr().out
    jevaluate_cli.main(["-n", nat, "-p", pred, "-o",
                        str(tmp_path / "jax" / "s.txt")])
    assert capsys.readouterr().out.replace("jax", "port") == out
    assert (tmp_path / "port" / "s.txt").read_bytes() == \
        (tmp_path / "jax" / "s.txt").read_bytes()
    assert sorted(os.listdir(tmp_path / "port")) == ["s.txt"]


def test_cluster_cli_copies_what_jax_copies(decoy_dir, tmp_path):
    args = ["-d", decoy_dir, "-m", "glocon", "--n_clusters", "3",
            "--n_files", "2"]
    tcluster_cli.main(args + ["-o", str(tmp_path / "port"), "--device",
                              "cpu"])
    jcluster_cli.main(args + ["-o", str(tmp_path / "jax")])
    got = sorted(os.listdir(tmp_path / "port"))
    assert got == sorted(os.listdir(tmp_path / "jax")) and len(got) == 6
    for fn in got:
        assert (tmp_path / "port" / fn).read_bytes() == \
            (tmp_path / "jax" / fn).read_bytes()

"""Ensemble clustering, the reference's cluster.py (glocon, tmscore and rmsd
modes).

Port of trx2dy/analysis/cluster.py (reference utils_trX2dy/utils.py:
526-616). The glocon distance between two decoys is the mean thresholded
distance-map difference over the upper triangle:

  score(a, b) = sum(triu(|D_a - D_b| where > 3 else 0)) / (L(L-1)/2)

computed on the device over the whole (N, N) decoy grid, a block of rows
at a time. The tmscore and rmsd modes take the native engine
(trx2dy_torch.native) for a same-length ensemble and the device TM-score
engine pair by pair otherwise, as JAX routes them. KMeans(n_init=10,
random_state=0) on the matrix rows is the reference's sklearn call; a
numpy k-means stands in where sklearn is absent.
"""
from __future__ import annotations

import itertools
import os
import shutil
from typing import Dict, List

import numpy as np
import torch

from trx2dy_torch import native
from trx2dy_torch.analysis.tmscore import align_common, tm_score_pair
from trx2dy_torch.device import resolve_device
from trx2dy_torch.geometry.transforms import geometry_maps_6d, virtual_cb
from trx2dy_torch.io.pdbio import read_pdb_backbone

# elements of one (rows, N, L, L) block of the glocon reduction
GLOCON_BLOCK_ELEMS = 1 << 26


def decoy_dist_maps(pdb_dir: str, device="cuda"):
    """((N, L, L) contact-masked CB distance maps, file names) of every
    decoy in pdb_dir, in os.listdir order, with the reference's 20 A cutoff
    and real-CB convention (get_neighbors, utils.py:125-182): the CB of the
    file where it has one, the virtual CB otherwise. The maps are computed
    on the device, one batch per residue count, and returned as numpy."""
    dev = resolve_device(device)
    files = [f for f in os.listdir(pdb_dir) if f.endswith(".pdb")]
    coords = [read_pdb_backbone(os.path.join(pdb_dir, fn))[0]
              for fn in files]
    maps = [None] * len(files)
    by_len: Dict[int, List[int]] = {}
    for k, c in enumerate(coords):
        by_len.setdefault(len(c["CA"]), []).append(k)
    for idx in by_len.values():
        n, ca, c, cb = (torch.as_tensor(
            np.stack([coords[k][a] for k in idx]), dtype=torch.float32,
            device=dev) for a in ("N", "CA", "C", "CB"))
        cb = torch.where(torch.isnan(cb), virtual_cb(n, ca, c), cb)
        dist = geometry_maps_6d(n, ca, c, cb=cb, dmax=20.0)["dist"]
        for k, m in zip(idx, dist.cpu().numpy()):
            maps[k] = m
    return np.stack(maps), files


def glocon_matrix_from_maps(dists) -> torch.Tensor:
    """(N, N) glocon matrix of (N, L, L) distance maps (a tensor, computed
    where it lies; numpy goes to the CPU), in blocks of rows that keep
    (rows, N, L, L) under GLOCON_BLOCK_ELEMS."""
    d = torch.as_tensor(dists)
    N, L, _ = d.shape
    triu = torch.triu(torch.ones((L, L), dtype=d.dtype, device=d.device))
    rows = max(1, GLOCON_BLOCK_ELEMS // max(1, N * L * L))
    out = []
    for s in range(0, N, rows):
        diff = torch.abs(d[None] - d[s:s + rows, None])    # (rows, N, L, L)
        diff = torch.where(diff <= 3.0, 0.0, diff)
        out.append(torch.sum(diff * triu, dim=(2, 3)) / (L * (L - 1) / 2.0))
    return torch.cat(out)


def tmscore_rmsd_matrices(pdb_dir: str, device="cuda"):
    """((N, N) TM-score, (N, N) RMSD, file names) of the decoys in pdb_dir
    (utils.py:526-540): the native engine for a same-length ensemble (the
    normal case, one target's decoys), the device engine pair by pair
    otherwise (residues matched by align_common)."""
    dev = resolve_device(device)
    files = [f for f in os.listdir(pdb_dir) if f.endswith(".pdb")]
    cas, seqs = [], []
    for fn in files:
        coords, seq = read_pdb_backbone(os.path.join(pdb_dir, fn))
        cas.append(coords["CA"])
        seqs.append(seq)
    N = len(files)
    if N and len({len(s) for s in seqs}) == 1:
        res = native.tmscore_matrix(np.stack(cas))
        if res is not None:
            return res[0], res[1], files
    tm = np.zeros((N, N))
    rmsd = np.zeros((N, N))
    for i, j in itertools.combinations(range(N), 2):
        ia, ib = align_common(seqs[i], seqs[j])
        r = tm_score_pair(cas[i][ia], cas[j][ib], device=dev)
        tm[i, j] = tm[j, i] = float(r.tm)
        rmsd[i, j] = rmsd[j, i] = float(r.rmsd)
    return tm, rmsd, files


def _kmeans(matrix: np.ndarray, n_clusters: int) -> np.ndarray:
    try:
        from sklearn.cluster import KMeans
    except ImportError:
        return _kmeans_numpy(matrix, n_clusters)
    km = KMeans(n_clusters=n_clusters, n_init=10, random_state=0)
    return km.fit(matrix).labels_


def _kmeans_numpy(matrix: np.ndarray, n_clusters: int) -> np.ndarray:
    """Lloyd's k-means from 10 seeded random starts, the lowest inertia
    kept (the JAX package's fallback); raises ValueError for fewer samples
    than clusters, as sklearn does."""
    rng = np.random.default_rng(0)
    best, best_inertia = None, np.inf
    for _ in range(10):
        centers = matrix[rng.choice(len(matrix), n_clusters, replace=False)]
        for _ in range(100):
            d = ((matrix[:, None] - centers[None]) ** 2).sum(-1)
            lab = d.argmin(1)
            new = np.stack([
                matrix[lab == k].mean(0) if (lab == k).any() else centers[k]
                for k in range(n_clusters)])
            if np.allclose(new, centers):
                break
            centers = new
        inertia = ((matrix - centers[lab]) ** 2).sum()
        if inertia < best_inertia:
            best, best_inertia = lab, inertia
    return best


def cluster_decoys(pdb_dir: str, n_clusters: int = 10, mode: str = "glocon",
                   device="cuda") -> Dict[int, List[str]]:
    """label -> file names of the decoys in pdb_dir."""
    if mode == "glocon":
        dists, files = decoy_dist_maps(pdb_dir, device)
        matrix = glocon_matrix_from_maps(
            torch.as_tensor(dists, device=resolve_device(device))
        ).cpu().numpy()
    elif mode == "tmscore":
        matrix, _, files = tmscore_rmsd_matrices(pdb_dir, device)
    elif mode == "rmsd":
        _, matrix, files = tmscore_rmsd_matrices(pdb_dir, device)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    labels = _kmeans(matrix, n_clusters)
    clusters: Dict[int, List[str]] = {}
    for fn, lab in zip(files, labels):
        clusters.setdefault(int(lab), []).append(fn)
    return clusters


def save_cluster_result(pdb_dir: str, n_clusters: int = 10, n_files: int = 5,
                        output_dir: str | None = None, mode: str = "glocon",
                        device="cuda"):
    """The reference's save_cluster_result (utils.py:593-616): copy the
    first n_files of each cluster into output_dir; "no_cluster" where
    k-means cannot run (fewer decoys than clusters)."""
    dev = resolve_device(device)
    output_dir = output_dir or os.path.join(pdb_dir, "clusters_result")
    os.makedirs(output_dir, exist_ok=True)
    try:
        clusters = cluster_decoys(pdb_dir, n_clusters=n_clusters, mode=mode,
                                  device=dev)
    except ValueError:
        return "no_cluster"
    for _, files in clusters.items():
        for fn in files[:n_files]:
            shutil.copy(os.path.join(pdb_dir, fn), output_dir)
    return clusters

"""Ensemble evaluation against native structures, the reference's
evaluate.py.

Port of trx2dy/analysis/evaluate.py. The reference spawns one bin/TMscore
process per (native, prediction) pair and parses its output
(utils_trX2dy/evaluate_utils.py:33-100). Here each native's predictions
are bucketed by (aligned length, prediction length) and every bucket is
one batched call of the device TM-score engine (analysis/tmscore.py).

summary.txt is byte-identical to the JAX package's and has the
reference's layout (evaluate_utils.py:70-100):

  <native> best_RMSD: <r> model: <pred> best_TM_score: <t> model: <pred>
  ...
  Mean RMSD: <r2>     # mean of the per-native best RMSDs, 2 decimals
  Mean TM-score: <t2>
  Min RMSD: <r2>
  Max TM-score: <t2>
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from trx2dy_torch.analysis.tmscore import align_common, tm_score_batch
from trx2dy_torch.device import resolve_device
from trx2dy_torch.io.pdbio import read_pdb_backbone


def _load_cas(pdb_dir: str) -> Dict[str, Tuple[np.ndarray, str, list]]:
    """file name -> (CA (L, 3), sequence, residue ids) of every .pdb in
    pdb_dir, in sorted order."""
    out = {}
    for fn in sorted(os.listdir(pdb_dir)):
        if not fn.endswith(".pdb"):
            continue
        coords, seq, resseq = read_pdb_backbone(
            os.path.join(pdb_dir, fn), return_resseq=True)
        out[fn] = (coords["CA"], seq, resseq)
    return out


def score_all(native_dir: str, pred_dir: str, align: bool = False,
              device="cuda"):
    """native name -> [(pred name, tm, rmsd), ...] over every pair.

    TM-score is normalised by the prediction's full length (the reference
    runs `TMscore native pred`, and TMscore normalises by its second
    structure), d0 likewise. Residues are matched by residue number
    (TMscore's default) unless align=True (sequence alignment, `-seq`,
    evaluate_utils.py:57-60); residues missing a CA on either side are
    left out, and a bucket of fewer than 4 aligned residues is skipped."""
    dev = resolve_device(device)
    natives = _load_cas(native_dir)
    preds = _load_cas(pred_dir)
    results: Dict[str, List[Tuple[str, float, float]]] = {}
    for nat_name, (nat_ca, nat_seq, nat_res) in natives.items():
        rows = []
        buckets: Dict[Tuple[int, int], list] = {}
        for pred_name, (pred_ca, pred_seq, pred_res) in preds.items():
            ia, ib = align_common(nat_seq, pred_seq, nat_res, pred_res,
                                  align=align)
            ok = ~(np.isnan(nat_ca[ia]).any(-1)
                   | np.isnan(pred_ca[ib]).any(-1))
            buckets.setdefault((int(ok.sum()), len(pred_seq)), []).append(
                (pred_name, nat_ca[ia][ok], pred_ca[ib][ok]))
        for (L, l_norm), items in buckets.items():
            if L < 4:
                continue
            r = tm_score_batch(np.stack([p for _, _, p in items]),
                               np.stack([n for _, n, _ in items]),
                               l_norm=l_norm, device=dev)
            for (pred_name, _, _), tm, rmsd in zip(
                    items, r.tm.tolist(), r.rmsd.tolist()):
                rows.append((pred_name, tm, rmsd))
        results[nat_name] = rows
    return results


def run_score(native_pdb_dir: str, pred_pdb_dir: str, align: bool = False,
              save_summary: bool = False, save_dir: str | None = None,
              device="cuda"):
    """The reference's run_score: each native's best models and the
    ensemble statistics; with save_summary, summary.txt in save_dir
    (default pred_pdb_dir).

    Returns (min_rmsd, max_tmscore, mean_rmsd, mean_tmscore) over the
    per-native best values (evaluate_utils.py:84-92), all None where no
    native has a scored prediction."""
    results = score_all(native_pdb_dir, pred_pdb_dir, align=align,
                        device=device)
    lines = []
    best_rmsds, best_tms = [], []

    def stem(s):
        return s.split("/")[-1].split(".")[0]

    for nat_name, rows in results.items():
        if not rows:
            continue
        best_r = min(rows, key=lambda t: t[2])
        best_t = max(rows, key=lambda t: t[1])
        lines.append(
            f"{stem(nat_name)} best_RMSD: {round(best_r[2], 3)} model: "
            f"{stem(best_r[0])} best_TM_score: {round(best_t[1], 4)} model: "
            f"{stem(best_t[0])}\n")
        best_rmsds.append(best_r[2])
        best_tms.append(best_t[1])
    if not best_rmsds:
        return None, None, None, None
    mean_rmsd = float(np.mean(best_rmsds))
    mean_tm = float(np.mean(best_tms))
    min_rmsd = float(np.min(best_rmsds))
    max_tm = float(np.max(best_tms))
    lines.append(f"Mean RMSD: {round(mean_rmsd, 2)}\n")
    lines.append(f"Mean TM-score: {round(mean_tm, 2)}\n")
    lines.append(f"Min RMSD: {round(min_rmsd, 2)}\n")
    lines.append(f"Max TM-score: {round(max_tm, 2)}\n")
    if save_summary:
        out_dir = save_dir or pred_pdb_dir
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "summary.txt"), "w") as f:
            f.write("".join(lines))
    return min_rmsd, max_tm, mean_rmsd, mean_tm

"""TM-score / RMSD engine, the stand-in for the reference's bin/TMscore.

Port of trx2dy/analysis/tmscore.py. The reference shells out to the
Zhang-lab TMscore binary per pair (utils_trX2dy/utils.py:514-523,
evaluate_utils.py:56-66); here a batch of (prediction, native) pairs is
scored in one computation on the device:

  * Kabsch optimal superposition (a batched 3x3 SVD with the determinant
    sign fix),
  * TM-score by the iterative-extension search: seed fragments of length
    L, L/2, L/4, ... >= 4 at stride len/2, superimpose on the seed, then
    for n_iter rounds re-superimpose on the residues within the cutoff
    (d0 + 1 for the first half of the rounds, d0 + 2.5 after), keeping
    the previous selection where fewer than 4 residues pass; the best
    score over every round and seed (Zhang & Skolnick, Proteins 2004),
  * d0 = 1.24 (L - 15)^(1/3) - 1.8 (at least 0.5),
  * RMSD of the common residues: plain Kabsch RMSD over the aligned CAs,
  * GDT-TS/HA from the seed superpositions.

Each round is one weighted covariance (B, S, 3, 3) over the B pairs and S
seeds and one batched SVD; nothing reads the device until the caller
does. Residues are matched by index (sequence-independent TMalign is not
implemented): align_common, nw_align and align_by_resseq give the index
maps, on the host in numpy, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from trx2dy_torch.device import resolve_device

# elements of a (B, S, L, 3) coordinate stack scored at once; larger
# batches are split into chunks of pairs (the all-vs-all matrix of 50
# decoys at L=150 is 1225 pairs x 136 seeds)
CHUNK_ELEMS = 1 << 24


class TMResult(NamedTuple):
    tm: torch.Tensor      # TM-score (normalised by l_norm)
    rmsd: torch.Tensor    # Kabsch RMSD over all common residues
    gdt_ts: torch.Tensor  # GDT-TS (1, 2, 4, 8 A)
    gdt_ha: torch.Tensor  # GDT-HA (0.5, 1, 2, 4 A)


def kabsch(P: torch.Tensor, Q: torch.Tensor, weights=None):
    """Optimal rotation and translation superposing P onto Q, (..., L, 3)
    each: (R (..., 3, 3), t (..., 3)) with R p + t ~ q, least squares
    under the (..., L) weights."""
    if weights is None:
        weights = torch.ones(P.shape[:-1], dtype=P.dtype, device=P.device)
    w = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-12)
    pc = torch.sum(P * w[..., None], dim=-2)
    qc = torch.sum(Q * w[..., None], dim=-2)
    H = torch.einsum("...li,...lj->...ij", (P - pc[..., None, :])
                     * w[..., None], Q - qc[..., None, :])
    U, _, Vh = torch.linalg.svd(H)
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    # R = V diag(1, 1, det) U^T: a reflection flips the last axis
    V = torch.cat([V[..., :2], V[..., 2:] * det[..., None, None]], dim=-1)
    R = V @ Ut
    t = qc - torch.einsum("...ij,...j->...i", R, pc)
    return R, t


def _distances(P, Q, weights):
    """Per-residue distances after superposing P onto Q on `weights`."""
    R, t = kabsch(P, Q, weights)
    moved = torch.einsum("...lj,...ij->...li", P, R) + t[..., None, :]
    return torch.linalg.vector_norm(moved - Q, dim=-1)


def kabsch_rmsd(P: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    d = _distances(P, Q, None)
    return torch.sqrt(torch.mean(d * d, dim=-1))


def tm_d0(L: int) -> float:
    """TM-score normalisation distance (Zhang & Skolnick 2004)."""
    if L > 15:
        return max(1.24 * (L - 15.0) ** (1.0 / 3.0) - 1.8, 0.5)
    return 0.5


def _seed_masks(L: int) -> np.ndarray:
    """(S, L) fragment seeds: lengths L, L/2, L/4, ... >= 4 at stride
    len/2."""
    seeds = []
    fl = L
    while fl >= 4:
        for off in range(0, L - fl + 1, max(1, fl // 2)):
            m = np.zeros(L, np.float32)
            m[off:off + fl] = 1.0
            seeds.append(m)
        fl //= 2
    return np.stack(seeds)


def _score(P, Q, n_iter: int, l_norm: int) -> TMResult:
    """TMResult of (B,) pairs P, Q (B, L, 3) on their device."""
    B, L, _ = P.shape
    d0 = tm_d0(l_norm)
    seeds = torch.as_tensor(_seed_masks(L), dtype=P.dtype, device=P.device)
    P_s, Q_s = P[:, None], Q[:, None]               # (B, 1, L, 3)
    sel = seeds.expand(B, -1, -1)                   # (B, S, L)
    cutoffs = [d0 + 1.0] * (n_iter // 2) + [d0 + 2.5] * (n_iter - n_iter // 2)
    best = None
    seed_d = None
    for cutoff in cutoffs + [None]:
        d = _distances(P_s, Q_s, sel)
        score = torch.mean(1.0 / (1.0 + (d / d0) ** 2), dim=-1)
        best = score if best is None else torch.maximum(best, score)
        if seed_d is None:
            seed_d = d                              # the seed frames
        if cutoff is None:
            break
        new = (d < cutoff).to(P.dtype)
        # keep >= 4 residues selected: else keep the previous selection
        sel = torch.where(new.sum(-1, keepdim=True) >= 4, new, sel)
    tm = best.amax(-1) * (L / float(l_norm))
    frac = {thr: torch.mean((seed_d < thr).to(P.dtype), dim=-1).amax(-1)
            for thr in (0.5, 1.0, 2.0, 4.0, 8.0)}
    return TMResult(
        tm=tm, rmsd=kabsch_rmsd(P, Q),
        gdt_ts=(frac[1.0] + frac[2.0] + frac[4.0] + frac[8.0]) / 4.0,
        gdt_ha=(frac[0.5] + frac[1.0] + frac[2.0] + frac[4.0]) / 4.0)


def _as_coords(a, dev) -> torch.Tensor:
    """A float tensor on dev: float32 unless a is a floating tensor."""
    if torch.is_tensor(a) and a.is_floating_point():
        return a.to(dev)
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                           device=dev)


def tm_score_batch(pred_cas, native_cas, n_iter: int = 20,
                   l_norm: Optional[int] = None,
                   device="cuda") -> TMResult:
    """TMResult of (B,) tensors on `device`: predictions (B, L, 3) against
    natives (B, L, 3), or one native (L, 3) for all, index-aligned.

    l_norm: the normalisation length. The TMscore binary sets d0 from, and
    divides the score sum by, the full length of its second structure even
    where fewer residues align; defaults to L. The pairs are scored in
    chunks of at most CHUNK_ELEMS coordinates per seed stack."""
    dev = resolve_device(device)
    P = _as_coords(pred_cas, dev)
    Q = _as_coords(native_cas, dev).to(P.dtype)
    if Q.dim() == 2:
        Q = Q.expand(P.shape[0], -1, -1)
    if P.dim() != 3 or P.shape[-1] != 3 or Q.shape != P.shape:
        raise ValueError(f"tm_score_batch: predictions (B, L, 3) and "
                         f"natives of the same shape or (L, 3), got "
                         f"{tuple(P.shape)} and {tuple(Q.shape)}")
    B, L, _ = P.shape
    l_norm = L if l_norm is None else l_norm
    chunk = max(1, CHUNK_ELEMS // (len(_seed_masks(L)) * L * 3))
    parts = [_score(P[s:s + chunk], Q[s:s + chunk], n_iter, l_norm)
             for s in range(0, B, chunk)]
    return TMResult(*(torch.cat(f) for f in zip(*parts)))


def tm_score_pair(pred_ca, native_ca, n_iter: int = 20,
                  l_norm: Optional[int] = None, device="cuda") -> TMResult:
    """TMResult of scalar tensors: a predicted CA trace against a native
    one, (L, 3) each, index-aligned (see tm_score_batch)."""
    pred = pred_ca if torch.is_tensor(pred_ca) else np.asarray(pred_ca)
    r = tm_score_batch(pred[None], native_ca, n_iter, l_norm, device)
    return TMResult(*(f[0] for f in r))


def nw_align(seq_a: str, seq_b: str, match: float = 1.0,
             mismatch: float = 0.0, gap: float = -1.0):
    """Needleman-Wunsch global alignment; returns (idx_a, idx_b) of the
    non-gap aligned columns.

    Scoring mirrors the TMscore binary's `-seq` mode (identity match 1,
    mismatch 0, gap -1; evaluate_utils.py:57-60). Host numpy dynamic
    programming, O(len_a * len_b)."""
    a = np.frombuffer(seq_a.encode(), np.uint8)
    b = np.frombuffer(seq_b.encode(), np.uint8)
    n, m = len(a), len(b)
    score = np.zeros((n + 1, m + 1), np.float32)
    ptr = np.zeros((n + 1, m + 1), np.int8)      # 0 diag, 1 up, 2 left
    score[:, 0] = gap * np.arange(n + 1)
    score[0, :] = gap * np.arange(m + 1)
    ptr[1:, 0] = 1
    ptr[0, 1:] = 2
    sub = np.where(a[:, None] == b[None, :], match, mismatch).astype(np.float32)
    for i in range(1, n + 1):
        diag = score[i - 1, :-1] + sub[i - 1]
        up = score[i - 1, 1:] + gap
        row = score[i]
        for j in range(1, m + 1):
            left = row[j - 1] + gap
            best = diag[j - 1]
            p = 0
            if up[j - 1] > best:
                best, p = up[j - 1], 1
            if left > best:
                best, p = left, 2
            row[j] = best
            ptr[i, j] = p
    ia, ib = [], []
    i, j = n, m
    while i > 0 or j > 0:
        p = ptr[i, j]
        if p == 0:
            i -= 1
            j -= 1
            ia.append(i)
            ib.append(j)
        elif p == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(ia[::-1], np.int64), np.asarray(ib[::-1], np.int64)


def align_by_resseq(res_a, res_b):
    """Match residues by residue number and insertion code (TMscore's
    default): (idx_a, idx_b) of the ids in both lists, in chain-a order;
    a repeated id keeps its first occurrence."""
    pos_b = {}
    for j, r in enumerate(res_b):
        pos_b.setdefault(r, j)
    ia, ib = [], []
    seen = set()
    for i, r in enumerate(res_a):
        if r in pos_b and r not in seen:
            seen.add(r)
            ia.append(i)
            ib.append(pos_b[r])
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)


def align_common(seq_a: str, seq_b: str, res_a=None, res_b=None,
                 align: bool = False):
    """(idx_a, idx_b) numpy index maps of the common residues of two chains
    of one protein, by the TMscore binary's rules: align=True, sequence
    alignment (`-seq`, Needleman-Wunsch); with residue ids on both sides,
    by residue number (its default); otherwise identity or exact
    subsequence anchoring, and Needleman-Wunsch where neither holds."""
    if align:
        return nw_align(seq_a, seq_b)
    if res_a is not None and res_b is not None:
        return align_by_resseq(res_a, res_b)
    if seq_a == seq_b:
        idx = np.arange(len(seq_a))
        return idx, idx
    if seq_b in seq_a:
        off = seq_a.index(seq_b)
        return np.arange(off, off + len(seq_b)), np.arange(len(seq_b))
    if seq_a in seq_b:
        off = seq_b.index(seq_a)
        return np.arange(len(seq_a)), np.arange(off, off + len(seq_a))
    return nw_align(seq_a, seq_b)

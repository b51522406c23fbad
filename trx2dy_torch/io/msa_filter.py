"""MSA diversity filtering — the hhfilter `-diff` reimplementation.

The port's own copy of trx2dy/io/msa_filter.py (host numpy; the port
imports nothing of the JAX package).

The reference shells out to HH-suite's hhfilter to reduce deep MSAs to a
maximally-diverse subset (`hhfilter -i .. -o .. -diff N`, then
`parse_a3m(filtered, limit=N)` — trRosettaX2/predict.py:141-147).

HH-suite's `-diff N` semantics (hhalignment.cc Filter2): sweep the
max-pairwise-sequence-identity cutoff upward from a strict 20%; at each
cutoff run the greedy max-identity filter (keep a sequence iff its identity
to every previously kept sequence is at or below the cutoff, always keeping
the query and preserving input order); accept the FIRST cutoff that leaves
at least N sequences in every 50-column alignment block (so sparse regions
of the alignment keep their coverage). The kept set may exceed N; the
reference then truncates to the first N rows in file order via the a3m
parse limit, which `filter_msa_diff` folds in.

Sequence identity matches HH-suite's convention: identical residues over
columns where both sequences have residues, normalized by the SHORTER
sequence's residue count.

Pure numpy; one O(N_rows x kept x L) pass per cutoff, kept staying at the
N-target scale for the accepted cutoff.
"""
from __future__ import annotations

import os

import numpy as np

from trx2dy_torch.io.a3m import _LOWER_TABLE

GAP = 20                       # a3m token for gap/unknown (io.a3m)
BLOCK = 50                     # hhfilter block length (columns)
_CUTOFFS = (0.20, 0.30, 0.40, 0.50, 0.60, 0.70, 0.80, 0.90)


def _greedy_max_id(msa: np.ndarray, nongap: np.ndarray, lens: np.ndarray,
                   cutoff: float, cover=None, need=None,
                   early_min: int = 0) -> tuple:
    """Indices kept by the max-pairwise-identity filter at one cutoff.

    When cover/need are given, the scan early-exits as soon as the kept set
    both reaches early_min rows AND satisfies the per-block coverage target
    — the acceptance condition is monotone in the growing kept set, so the
    accepted/rejected verdict and the kept-set PREFIX are unchanged; only
    tail rows the caller would truncate anyway are skipped. This bounds the
    per-cutoff work for deep redundant MSAs (30000-row parse limit), where
    a high cutoff would otherwise keep nearly every row.

    Returns (kept_indices, coverage_satisfied).
    """
    N, L = msa.shape
    kept_rows = np.empty((N, L), msa.dtype)
    kept_ng = np.empty((N, L), bool)
    kept_len = np.empty(N, np.int64)
    kept_idx = np.empty(N, np.int64)
    kept_rows[0], kept_ng[0], kept_len[0], kept_idx[0] = (
        msa[0], nongap[0], lens[0], 0)
    k = 1
    check_every = max(int(early_min), 256)
    next_check = max(int(early_min), 2)
    for i in range(1, N):
        both = kept_ng[:k] & nongap[i]
        ident = ((kept_rows[:k] == msa[i]) & both).sum(axis=1)
        denom = np.maximum(np.minimum(kept_len[:k], lens[i]), 1)
        if (ident <= cutoff * denom).all():
            kept_rows[k], kept_ng[k] = msa[i], nongap[i]
            kept_len[k], kept_idx[k] = lens[i], i
            k += 1
            if cover is not None and k >= next_check:
                if (cover[kept_idx[:k]].sum(axis=0) >= need).all():
                    return kept_idx[:k], True
                next_check = k + check_every
    ok = cover is not None and \
        bool((cover[kept_idx[:k]].sum(axis=0) >= need).all())
    return kept_idx[:k], ok


def hhfilter_diff_indices(msa: np.ndarray, n_keep: int,
                          exact: bool = False) -> np.ndarray:
    """hhfilter `-diff n_keep`: the accepted-cutoff kept set (may exceed
    n_keep, exactly like the binary's output file).

    By default the sweep early-exits once a cutoff's kept set reaches
    n_keep rows with block coverage satisfied, so the result is the exact
    PREFIX of the binary's accepted set — at least n_keep rows, identical
    under the first-n_keep parse truncation, but possibly shorter than the
    binary's full output file. Pass exact=True to re-run the greedy filter
    at the accepted cutoff without the early exit, reproducing the FULL
    accepted set (what the binary writes to disk) — used when the result
    feeds a reusable on-disk artifact (predict.py's filter{nrows}.a3m).
    The extra cost is one unbounded greedy pass at the single accepted
    cutoff, not at every cutoff in the sweep.
    """
    msa = np.asarray(msa)
    N, L = msa.shape
    if N <= n_keep:
        return np.arange(N)
    nongap = msa != GAP
    lens = nongap.sum(axis=1).astype(np.int64)

    starts = np.arange(0, max(L, 1), BLOCK)
    # per-row block coverage: does the row have residues in block b?
    cover = np.stack([nongap[:, s:s + BLOCK].any(axis=1) for s in starts],
                     axis=1)                                  # (N, n_blocks)
    total = cover.sum(axis=0)                                 # per block
    need = np.minimum(total, n_keep)

    cand = np.arange(N)
    for cutoff in _CUTOFFS:
        cand, ok = _greedy_max_id(msa, nongap, lens, cutoff,
                                  cover=cover, need=need, early_min=n_keep)
        if ok:
            if exact and len(cand) < N:
                # full accepted set at this cutoff (early exit off)
                cand, _ = _greedy_max_id(msa, nongap, lens, cutoff)
            return cand
    # No cutoff met the per-block coverage target. HH-suite still emits the
    # max-cutoff (90%) filtered set in this case — keep ITS rows rather
    # than falling back to the unfiltered (near-duplicate) input order.
    # (The early exit cannot have fired without coverage, so this set is
    # already the complete 90%-cutoff filter.)
    return cand


def filter_msa_diff(msa: np.ndarray, n_keep: int) -> np.ndarray:
    """hhfilter `-diff n_keep` + the reference's parse-limit truncation
    (predict.py:146 `parse_a3m(filtered, limit=nrows)` takes the first
    nrows rows of the filtered file, i.e. input order).

    Returns row indices (input order, query first), at most n_keep of them.
    """
    return hhfilter_diff_indices(msa, n_keep)[:n_keep]


def hhfilter_equivalent(msa: np.ndarray, nrows: int,
                        trigger_ratio: float = 1.1) -> np.ndarray:
    """predict.py:141-147 semantics: filter only when len(msa) exceeds
    trigger_ratio * nrows; otherwise return the MSA unchanged."""
    if msa.shape[0] > trigger_ratio * nrows:
        return msa[filter_msa_diff(msa, nrows)]
    return msa


def write_filtered_a3m(src_path: str, dst_path: str, indices,
                       limit: int = 30000) -> None:
    """Write the a3m entries at the given parsed-row indices to dst_path.

    The reference's predict.py shells out to hhfilter to produce the
    `filter{nrows}.a3m` artifact (predict.py:142-144), which preserves the
    source entries verbatim (headers + lowercase insertions). This mirrors
    that artifact from in-process filter indices: rows are numbered the way
    parse_a3m counts them (header lines skipped, wrong-length rows skipped,
    `limit` cap), so index k here is row k of parse_a3m(src_path, limit)."""
    with open(src_path) as f:
        lines = f.readlines()
    try:
        seq_len = len(lines[1].strip())
    except IndexError:
        seq_len = None
    want = set(int(i) for i in np.asarray(indices))
    out, row, header = [], 0, None
    for line in lines:
        if not line:
            continue
        if line[0] == ">":
            header = line.rstrip("\n")
            continue
        s = line.rstrip().translate(_LOWER_TABLE)
        if seq_len is not None and len(s) != seq_len:
            header = None
            continue
        if row in want:
            out.append((row, header if header is not None else f">seq_{row}",
                        line.rstrip("\n")))
        header = None
        row += 1
        if row >= limit:
            break
    out.sort(key=lambda t: t[0])
    # atomic publish: a crash mid-write must not leave a partial artifact
    # that later runs silently reuse (predict.py gates on isfile)
    tmp_path = dst_path + ".tmp"
    with open(tmp_path, "w") as f:
        for _, h, s in out:
            f.write(h + "\n" + s + "\n")
    os.replace(tmp_path, dst_path)

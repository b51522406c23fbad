"""MSA (a3m) and FASTA parsing with the reference's 21-token alphabet.

Reference: utils_trX2dy/utils.py:733-765 (parse_a3m) and
folding/folding.py:17-29 (read_fasta). Tokens: ARNDCQEGHILKMFPSTWYV- = 0..20;
unknown characters map to the gap token 20; lowercase insertion states and
'*' are stripped; sequences whose length differs from the query are skipped.

The port keeps its own copy so that it imports nothing of the JAX package.
Tokens come out as uint8 numpy arrays; callers cast to int64 before they
index an embedding with them.
"""
from __future__ import annotations

import string
import warnings

import numpy as np

ALPHABET = "ARNDCQEGHILKMFPSTWYV-"
_LOWER_TABLE = str.maketrans(dict.fromkeys(string.ascii_lowercase + "*"))

_CHAR_TO_TOKEN = np.full(256, 20, dtype=np.uint8)
for _i, _c in enumerate(ALPHABET):
    _CHAR_TO_TOKEN[ord(_c)] = _i


def seq_to_ints(seq: str) -> np.ndarray:
    """Encode an amino-acid string into 0..20 tokens (unknown -> 20)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _CHAR_TO_TOKEN[raw]


def parse_a3m(filename: str, limit: int = 20000) -> np.ndarray:
    """Parse an a3m file into an (N, L) uint8 token matrix.

    Query length is taken from the second line; lowercase/'*' stripped;
    wrong-length rows skipped; at most `limit` rows.
    """
    return parse_a3m_deletions(filename, limit)[0]


def parse_a3m_deletions(filename: str, limit: int = 20000) -> tuple:
    """parse_a3m's (N, L) uint8 tokens and, beside them, (N, L) int32
    deletion counts: the lowercase insertion letters each row carries
    before each column (AlphaFold2's deletion matrix)."""
    with open(filename) as f:
        lines = f.readlines()
    try:
        seq_len = len(lines[1].strip().translate(_LOWER_TABLE))
    except IndexError:
        seq_len = None
    seqs, dels = [], []
    for line in lines:
        if not line or line[0] == ">":
            continue
        raw = np.frombuffer(line.rstrip().encode("ascii"), dtype=np.uint8)
        lower = (raw >= ord("a")) & (raw <= ord("z"))
        keep = ~lower & (raw != ord("*"))
        if seq_len is not None and int(keep.sum()) != seq_len:
            continue
        seqs.append(_CHAR_TO_TOKEN[raw[keep]])
        dels.append(np.diff(np.cumsum(lower)[keep], prepend=0))
        if len(seqs) >= limit:
            break
    return np.stack(seqs), np.stack(dels).astype(np.int32)


def read_fasta(file: str) -> str:
    """First protein chain from a FASTA file (reference folding.py:17-29)."""
    fasta = ""
    with open(file) as f:
        for line in f:
            if line.startswith(">"):
                if fasta:
                    warnings.warn(
                        "Submitted protein contained multiple chains. "
                        "Only the first protein chain will be used"
                    )
                    break
                continue
            fasta += line.rstrip()
    return fasta

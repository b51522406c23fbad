"""Synthetic inputs made from a seed: MSAs, backbones, folding targets.

write_synthetic_a3m, compact_walk and synthetic_target are frozen copies
of chip_smoke.py's (as of the benchmark's first version); synthetic_msa
is write_synthetic_a3m's token draw without the file, so the tokens it
returns are those the port's a3m parser reads back from that file.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

# the 21-token alphabet of the a3m parser (trx2dy_torch/io/a3m.py)
ALPHABET = "ARNDCQEGHILKMFPSTWYV-"


def synthetic_msa(L: int, rows: int, rng: np.random.Generator) -> np.ndarray:
    """(rows, L) uint8 tokens: a query and `rows - 1` homologs at 10-70 %
    mutation with 10 % gaps."""
    query = rng.integers(0, 20, L)
    rate = rng.uniform(0.1, 0.7, (rows, 1))
    msa = np.where(rng.random((rows, L)) < rate,
                   rng.integers(0, 20, (rows, L)), query)
    msa = np.where(rng.random((rows, L)) < 0.1, 20, msa)
    msa[0] = query
    return msa.astype(np.uint8)


def write_synthetic_a3m(path: Path, L: int, rows: int, seed: int) -> None:
    """A query and `rows - 1` homologs at 10-70% mutation with 10% gaps;
    every tenth homolog carries a lowercase insertion the parser strips."""
    rng = np.random.default_rng(seed)
    letters = np.array(list(ALPHABET))
    msa = synthetic_msa(L, rows, rng)
    with open(path, "w") as f:
        for n, toks in enumerate(msa):
            s = "".join(letters[toks])
            if n and n % 10 == 0:
                cut = int(rng.integers(1, L))
                s = s[:cut] + "ak" + s[cut:]
            f.write(f">seq{n}\n{s}\n")


def query_sequence(msa: np.ndarray) -> str:
    """The one-letter query (row 0) of a token MSA."""
    return "".join(ALPHABET[t] for t in msa[0])


def compact_walk(L: int, seed: int) -> np.ndarray:
    """Compact self-avoiding CA walk: 3.8 A steps, >= 4 A self-clearance,
    inside a globule-sized sphere (scripts/native_recovery.py:48-71)."""
    rng = np.random.default_rng(seed)
    R = 2.9 * L ** 0.38
    pts = np.zeros((L, 3))
    i = 1
    while i < L:
        for _ in range(200):
            u = rng.normal(size=3)
            cand = pts[i - 1] + 3.8 * u / np.linalg.norm(u)
            if np.linalg.norm(cand) > R:
                continue
            if i > 3 and np.linalg.norm(
                    pts[:i - 2] - cand, axis=1).min() < 4.0:
                continue
            pts[i] = cand
            i += 1
            break
        else:
            i = max(1, i - 5)        # backtrack out of dead ends
    return pts


def synthetic_target(L: int, seed: int) -> dict:
    """Sharp dist histograms of a compact walk and uniform orientation
    histograms (scripts/native_recovery.py:89-100)."""
    walk = compact_walk(L, seed)
    d = np.linalg.norm(walk[:, None] - walk[None, :], axis=-1)
    centers = 2.25 + 0.5 * np.arange(36)          # contact bins, 2-20 A
    dist = np.exp(-0.5 * ((d[..., None] - centers) / 0.75) ** 2)
    dist = np.where(d[..., None] < 20.0, dist, 0.0)
    no_contact = (d >= 20.0).astype(np.float64)
    dist = np.concatenate([no_contact[..., None], dist], -1)
    dist /= dist.sum(-1, keepdims=True)
    uniform = {k: np.full((L, L, n), 1.0 / n, np.float32)
               for k, n in (("omega", 25), ("theta", 25), ("phi", 13))}
    return {"dist": dist.astype(np.float32), **uniform}


# ideal backbone geometry (Engh & Huber): bond lengths (A), angles (deg)
_BONDS = {"N-CA": 1.458, "CA-C": 1.525, "C-N": 1.329}
_ANGLES = {"N-CA-C": 111.2, "CA-C-N": 116.2, "C-N-CA": 121.7}


def _place(a, b, c, bond, angle, torsion):
    """The atom at `bond` from c, with angle b-c-d and dihedral a-b-c-d
    (NeRF)."""
    bc = c - b
    bc /= np.linalg.norm(bc)
    n = np.cross(b - a, bc)
    n /= np.linalg.norm(n)
    m = np.stack([bc, np.cross(n, bc), n], axis=-1)
    d2 = bond * np.array([-np.cos(angle), np.sin(angle) * np.cos(torsion),
                          np.sin(angle) * np.sin(torsion)])
    return c + m @ d2


def synthetic_backbone(L: int, rng: np.random.Generator) -> dict:
    """{N, CA, C: (L, 3)} of a chain built by NeRF from ideal geometry:
    helix and strand segments of 6-20 residues, torsions within 10
    degrees of each, omega 180."""
    phi, psi = np.empty(L), np.empty(L)
    i = 0
    while i < L:
        n = int(rng.integers(6, 21))
        phi[i:i + n], psi[i:i + n] = ((-63.0, -42.0), (-120.0, 130.0))[
            int(rng.integers(2))]
        i += n
    phi = np.deg2rad(phi + rng.normal(0.0, 10.0, L))
    psi = np.deg2rad(psi + rng.normal(0.0, 10.0, L))
    ang = {k: np.deg2rad(v) for k, v in _ANGLES.items()}
    atoms = [np.array([0.0, -1.0, 0.0]), np.array([0.0, 0.0, 0.0]),
             np.array([_BONDS["CA-C"], 0.0, 0.0])]
    atoms[0] = atoms[1] + _BONDS["N-CA"] * np.array(
        [np.cos(ang["N-CA-C"]), np.sin(ang["N-CA-C"]), 0.0])
    for r in range(1, L):
        n_at = _place(atoms[-3], atoms[-2], atoms[-1], _BONDS["C-N"],
                      ang["CA-C-N"], psi[r - 1])
        ca = _place(atoms[-2], atoms[-1], n_at, _BONDS["N-CA"],
                    ang["C-N-CA"], np.pi)
        c = _place(atoms[-1], n_at, ca, _BONDS["CA-C"], ang["N-CA-C"],
                   phi[r])
        atoms += [n_at, ca, c]
    xyz = np.asarray(atoms).reshape(L, 3, 3)
    return {"N": xyz[:, 0], "CA": xyz[:, 1], "C": xyz[:, 2]}

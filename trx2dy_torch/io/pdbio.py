"""Minimal PDB reading and writing for backbone(+CB) models.

The port's own copy of trx2dy/io/pdbio.py's backbone functions. The
writer follows the strict 80-column ATOM record layout of the reference
(trRosettaX2/strutils/utils_3d/prot_converter.py:292-385); the reader
takes the atoms the Dynamics loop needs (N, CA, C, O, CB).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

# 3-letter <-> 1-letter residue names (reference utils.py:25-54 superset)
AA3_TO_1 = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "PHD": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I", "LEU": "L",
    "LYS": "K", "MET": "M", "MSE": "M", "PHE": "F", "PRO": "P", "SER": "S",
    "THR": "T", "TRP": "W", "UNK": "X", "TYR": "Y", "VAL": "V", "SEC": "U",
    "ASX": "B", "GLX": "Z", "XLE": "J", "XAA": "X",
}
AA1_TO_3 = {
    "A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS", "Q": "GLN",
    "E": "GLU", "G": "GLY", "H": "HIS", "I": "ILE", "L": "LEU", "K": "LYS",
    "M": "MET", "F": "PHE", "P": "PRO", "S": "SER", "T": "THR", "W": "TRP",
    "Y": "TYR", "V": "VAL", "X": "UNK", "U": "SEC", "B": "ASX", "Z": "GLX",
}

BACKBONE_ATOMS = ("N", "CA", "C", "O", "CB")
_ELEMENT = {"N": "N", "CA": "C", "C": "C", "O": "O", "CB": "C"}


def write_pdb_backbone(path: str, seq: str, coords: Dict[str, np.ndarray],
                       bfactors: np.ndarray | None = None,
                       chain: str = "A") -> None:
    """Write a backbone(+CB) model; coords: atom -> (L, 3) (numpy).
    Glycine CB records and non-finite atoms are skipped."""
    L = len(seq)
    if bfactors is None:
        bfactors = np.zeros(L)
    lines = []
    serial = 1
    for i in range(L):
        res3 = AA1_TO_3.get(seq[i], "UNK")
        for atom in BACKBONE_ATOMS:
            if atom == "CB" and seq[i] == "G":
                continue
            if atom not in coords:
                continue
            x, y, z = np.asarray(coords[atom][i], dtype=float)
            if not np.all(np.isfinite((x, y, z))):
                continue
            lines.append(
                f"ATOM  {serial:5d}  {atom:<3s} {res3:>3s} {chain}"
                f"{i + 1:4d}    {x:8.3f}{y:8.3f}{z:8.3f}"
                f"{1.00:6.2f}{float(bfactors[i]):6.2f}          "
                f"{_ELEMENT[atom]:>2s}  ")
            serial += 1
    lines += ["TER", "END"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_pdb_backbone(path: str, return_resseq: bool = False):
    """N/CA/C/O/CB coordinates of the first model and chain of a PDB file:
    (coords atom -> (L, 3) with NaN for missing atoms, sequence[, residue
    ids]). Residues are numbered by order of appearance."""
    residues: dict = {}
    order = []
    chain_seen = None
    with open(path) as f:
        for line in f:
            if line.startswith("ENDMDL"):
                break
            if not line.startswith(("ATOM", "HETATM")):
                continue
            resname = line[17:20].strip()
            if resname not in AA3_TO_1 or line[16] not in (" ", "A"):
                continue
            chain = line[21]
            if chain_seen is None:
                chain_seen = chain
            elif chain != chain_seen:
                continue
            key = (chain, line[22:27])   # residue number + insertion code
            atom = line[12:16].strip()
            if key not in residues:
                residues[key] = {"name": resname, "atoms": {}}
                order.append(key)
            if atom in BACKBONE_ATOMS and atom not in residues[key]["atoms"]:
                residues[key]["atoms"][atom] = (
                    float(line[30:38]), float(line[38:46]), float(line[46:54]))
    L = len(order)
    coords = {a: np.full((L, 3), np.nan) for a in BACKBONE_ATOMS}
    seq = []
    for i, key in enumerate(order):
        rec = residues[key]
        seq.append(AA3_TO_1[rec["name"]])
        for a, xyz in rec["atoms"].items():
            coords[a][i] = xyz
    if return_resseq:
        return coords, "".join(seq), [key[1].strip() for key in order]
    return coords, "".join(seq)

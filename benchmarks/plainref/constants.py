"""AF2 residue-constant tables (amino-acid biochemistry data).

A frozen copy of the port's trx2dy_torch/models/constants.py, loaded from
a copy of its af2_constants.npz beside this file, cut to the tables the
structure module reads: the standard AlphaFold rigid-group literature atom
positions, atom14 layout and default inter-group frames that the reference
vendors at
trRosettaX2/strutils/utils_3d/protein_constants.py:27-989. Loaded once at
import.
"""
from __future__ import annotations

import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "af2_constants.npz")
with np.load(_DATA, allow_pickle=False) as _npz:
    restypes = [str(c) for c in _npz["restypes"]]                   # 20
    # torsion -> frame machinery (protein_constants._make_rigid_group_...)
    restype_rigid_group_default_frame = _npz[
        "restype_rigid_group_default_frame"].astype(np.float32)     # (21,8,4,4)
    restype_atom14_to_rigid_group = _npz[
        "restype_atom14_to_rigid_group"].astype(np.int32)           # (21, 14)
    restype_atom14_mask = _npz["restype_atom14_mask"].astype(np.float32)
    restype_atom14_rigid_group_positions = _npz[
        "restype_atom14_rigid_group_positions"].astype(np.float32)  # (21,14,3)

restype_order = {r: i for i, r in enumerate(restypes)}
unk_restype_index = len(restypes)                                   # 'X' = 20


def sequence_to_aatype(seq: str) -> np.ndarray:
    """One-letter sequence -> aatype indices (unknown -> 20)."""
    return np.asarray([restype_order.get(c, unk_restype_index) for c in seq],
                      dtype=np.int32)

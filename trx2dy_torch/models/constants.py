"""AF2 residue-constant tables (amino-acid biochemistry data).

The port's own copy of trx2dy/models/constants.py, loaded from its own copy
of af2_constants.npz (models/data/): the standard AlphaFold residue tables
(chi-angle atom groups, rigid-group literature atom positions, atom14
layout, default inter-group frames) that the reference vendors at
trRosettaX2/strutils/utils_3d/protein_constants.py:27-989. Loaded once at
import.
"""
from __future__ import annotations

import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "data", "af2_constants.npz")
with np.load(_DATA, allow_pickle=False) as _npz:
    restypes = [str(c) for c in _npz["restypes"]]                   # 20
    restype_3 = [str(s) for s in _npz["restype_3"]]
    atom_types = [str(s) for s in _npz["atom_types"]]               # 37
    atom14_names = _npz["restype_name_to_atom14_names"]             # (21, 14)
    chi_angles_mask = _npz["chi_angles_mask"]                       # (21, 4)
    chi_pi_periodic = _npz["chi_pi_periodic"]                       # (21, 4)
    # torsion -> frame machinery (protein_constants._make_rigid_group_...)
    restype_rigid_group_default_frame = _npz[
        "restype_rigid_group_default_frame"].astype(np.float32)     # (21,8,4,4)
    restype_atom14_to_rigid_group = _npz[
        "restype_atom14_to_rigid_group"].astype(np.int32)           # (21, 14)
    restype_atom14_mask = _npz["restype_atom14_mask"].astype(np.float32)
    restype_atom14_rigid_group_positions = _npz[
        "restype_atom14_rigid_group_positions"].astype(np.float32)  # (21,14,3)
    restype_atom37_mask = _npz["restype_atom37_mask"].astype(np.float32)
    van_der_waals_radius = {
        str(k): float(v) for k, v in zip(_npz["van_der_waals_radius_keys"],
                                         _npz["van_der_waals_radius_values"])
    }

restype_order = {r: i for i, r in enumerate(restypes)}
restype_num = len(restypes)
unk_restype_index = restype_num                                     # 'X' = 20


def sequence_to_aatype(seq: str) -> np.ndarray:
    """One-letter sequence -> aatype indices (unknown -> 20)."""
    return np.asarray([restype_order.get(c, unk_restype_index) for c in seq],
                      dtype=np.int32)

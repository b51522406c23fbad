#!/usr/bin/env python3
"""Fold chip_smoke.py's synthetic L=150 target without relax (its request
(a) up to PR 3, which every tree since PR 2 runs) with the port of a given
tree, for comparing two trees on one GPU in one call.

    python3 scripts/fold_compare.py TREE LABEL

TREE is the root of a checkout (this repository's, or an older commit's
unpacked with `git archive` into a directory git ignores). Its
chip_smoke.py and trx2dy_torch are imported, so each tree runs its own
code. The script folds the synthetic compact L=150 target into 50 decoys
(mode 2, max_iter 1000, no relax), then profiles one 250-iteration L-BFGS
chunk of the centroid stage, and prints two JSON lines: wall time,
energy evaluations, ms per evaluation, host syncs and median energy; and
ms per evaluation, device-busy share and kernel launches per evaluation
of the chunk. Run trees in turns (A, B, B, A): host speed on one machine
drifts.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("fold_compare: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    if Path(cs.__file__).resolve().parent != root:
        print(f"fold_compare: imported {cs.__file__}, not {root}",
              file=sys.stderr)
        return 1
    from trx2dy_torch.device import resolve_device
    from trx2dy_torch.physics.folder import fold_ensemble
    from trx2dy_torch.physics.minimize import STATS

    dev = resolve_device("cuda")
    npz = cs.synthetic_target(cs.FOLD_L, seed=1)
    seq = "A" * cs.FOLD_L
    energy_a, _, _, _ = cs.centroid_energy(npz, seq, dev)
    x0 = cs.start_torsions(7, cs.FOLD_L, cs.FOLD_DECOYS, dev)
    torch.cuda.synchronize(dev)
    STATS.reset()
    t0 = time.perf_counter()
    res = fold_ensemble(npz, seq, torch.Generator().manual_seed(7),
                        n_decoys=cs.FOLD_DECOYS, max_iter=cs.FOLD_ITERS,
                        fastrelax=False, use_orient=True, device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    print("fold " + json.dumps({
        "tree": sys.argv[2], "wall_s": wall, "energy_evals": STATS.evals,
        "ms_per_eval": 1e3 * wall / STATS.evals, "host_syncs": STATS.syncs,
        "median_energy": float(res.energy.median())}), flush=True)
    prof = cs.profile_chunk(energy_a, x0, dev)
    print("chunk " + json.dumps({
        "tree": sys.argv[2],
        "ms_per_eval": 1e3 * prof["wall_s"] / prof["energy_evals"],
        "device_busy_share": prof["device_busy_share"],
        "launches_per_eval": prof["launches_per_eval"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

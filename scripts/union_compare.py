#!/usr/bin/env python3
"""Time the Dynamics sampler's union energy (one stage of its fold) with
the port of a given tree, for comparing two trees on one GPU in one call.

    python3 scripts/union_compare.py TREE LABEL [chain|initial]

TREE is the root of a checkout (this repository's, or an older commit's
unpacked with `git archive` into a directory git ignores). Its
chip_smoke.py and trx2dy_torch are imported, so each tree runs its own
code. The script compiles a sampler fold's tables as the driver does at
phase 6's shape (16 random histograms at L=64, 32 lanes: a chain step's
16 chains x 2 candidates, or with `initial` the initial fold's 2 x 13
lanes from the first chain of each model padded with the last; the full
union's bucketed pair counts, the first centroid stage's activity), then
times 300 value-and-gradient evaluations of batched_energy_weighted_union
back to back (host clock, synchronised at the end) and one unprofiled
250-iteration L-BFGS chunk of it, and prints one JSON line: ms per
evaluation of each, the chunk's evaluations, SHA-256 digests of each
term's per-lane y and m tables (equal digests: bit-identical tables) and
the first evaluation's energies.
Run trees in turns (A, B, B, A): host speed on one machine drifts.
"""
from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

L, CHAINS, CAND, EVALS, ITERS = 64, 16, 2, 300, 250


def main() -> int:
    if len(sys.argv) not in (3, 4) or sys.argv[3:] not in ([], ["chain"],
                                                          ["initial"]):
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("union_compare: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    if Path(cs.__file__).resolve().parent != root:
        print(f"union_compare: imported {cs.__file__}, not {root}",
              file=sys.stderr)
        return 1
    from trx2dy_torch.device import resolve_device
    from trx2dy_torch.ops import spline_energy as se
    from trx2dy_torch.physics import energy
    from trx2dy_torch.physics.compact import _bucket, union_stage
    from trx2dy_torch.physics.minimize import STATS, lbfgs_init, lbfgs_run
    from trx2dy_torch.physics.tablegen import union_compiler

    dev = resolve_device("cuda")
    hists = [cs.random_histograms(L, seed=L + u) for u in range(CHAINS)]
    pool = {g: torch.as_tensor(np.stack([h[g] for h in hists]), device=dev)
            for g in cs.GRIDS}
    comp = union_compiler("A" * L, device=dev)
    P = tuple(_bucket(int(c)) for c in comp.count(pool)[0].tolist())
    lane_map = np.repeat([0, CHAINS // 2], [13, CHAINS * CAND - 13]) \
        if sys.argv[3:] == ["initial"] else np.repeat(np.arange(CHAINS), CAND)
    ur, acts, _, _ = comp.compile(pool, lane_map, P)
    stage = union_stage(ur, acts[0])
    digests = []
    for t in ur:       # per-lane (P, C, K) y, m: the earlier storage
        y, m = (t.y, t.m) if hasattr(t, "y") else \
            se.expand_lane_tables(t.tab, t.row)
        digests.append([hashlib.sha256(a.contiguous().cpu().numpy()
                                       .tobytes()).hexdigest()[:16]
                        for a in (y, m)])
    w = torch.as_tensor(energy.weights_to_vec(energy.SCOREFXN_CENT),
                        device=dev)

    def fun(x):
        return energy.batched_energy_weighted_union(x, stage, w)

    x0 = cs.start_torsions(11, L, CHAINS * CAND, dev)
    first, _ = cs.value_and_grad(fun, x0)
    for _ in range(3):                                  # warm
        cs.value_and_grad(fun, x0)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(EVALS):
        cs.value_and_grad(fun, x0)
    torch.cuda.synchronize(dev)
    eval_ms = 1e3 * (time.perf_counter() - t0) / EVALS

    st = lbfgs_run(fun, lbfgs_init(fun, x0), 2)
    torch.cuda.synchronize(dev)
    STATS.reset()
    t0 = time.perf_counter()
    lbfgs_run(fun, st, ITERS)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    print("union " + json.dumps({
        "tree": sys.argv[2], "map": (sys.argv[3:] or ["chain"])[0], "L": L,
        "lanes": CHAINS * CAND,
        "eval_ms": eval_ms, "chunk_wall_s": wall,
        "chunk_evals": STATS.evals,
        "chunk_ms_per_eval": 1e3 * wall / max(STATS.evals, 1),
        "tables_sha256": digests,
        "first_energy": first.cpu().tolist()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

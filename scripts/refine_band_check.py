#!/usr/bin/env python3
"""The cartesian refinement's displacements in the JAX package and in the
PyTorch port, on the CPU, from the same start.

    JAX_PLATFORMS=cpu python3 scripts/refine_band_check.py jax|port \\
        [--L 40] [--decoys 6] [--iters 100] [--stage-iters 20]

Folds chip_smoke.py's synthetic compact target (L residues, a seeded
sequence without GLY or CYS) at the fold defaults (FastRelax with the
round-1 cartesian block, the final cartesian refinement), every relax and
cartesian ramp stage cut to --stage-iters iterations and the centroid
stages to --iters, from the start torsions chip_smoke.py draws for seed 7.
Prints the final centroid energies, the smallest and largest CA-CA
distance and, per decoy, the largest CA displacement of the refined atoms
from the NeRF build of the returned torsions (the final refinement's
move). Run once per package; the two print the same statistics.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("package", choices=["jax", "port"])
    ap.add_argument("--L", type=int, default=40)
    ap.add_argument("--decoys", type=int, default=6)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--stage-iters", type=int, default=20)
    args = ap.parse_args()

    import torch
    import chip_smoke as cs
    from trx2dy_torch.geometry import nerf as tnerf
    from trx2dy_torch.physics import folder as tfolder

    L, B = args.L, args.decoys
    npz = cs.synthetic_target(L, seed=1)
    seq = cs.synthetic_sequence(L, seed=1)
    x0 = tfolder.random_torsions(torch.Generator().manual_seed(7), L,
                                 B).numpy()
    short = tuple((fa, cst, args.stage_iters)
                  for fa, cst, _ in tfolder.RELAX_SCHEDULE_R1)

    t0 = time.perf_counter()
    if args.package == "port":
        torch.set_num_threads(4)
        mod = tfolder
        for name in ("RELAX_SCHEDULE_R1", "RELAX_SCHEDULE_R2",
                     "CART_SCHEDULE_R1"):
            setattr(mod, name, short)
        res = tfolder.fold_ensemble(npz, seq, None, n_decoys=B,
                                    max_iter=args.iters, x0=x0,
                                    device="cpu")
        energy = res.energy.numpy()
        tors = res.torsions
        atoms = {k: v.numpy() for k, v in res.atoms.items()}
    else:
        import jax
        import jax.numpy as jnp
        jax.config.update("jax_platforms", "cpu")
        from trx2dy.physics import folder as jfolder
        for name in ("RELAX_SCHEDULE_R1", "RELAX_SCHEDULE_R2",
                     "CART_SCHEDULE_R1"):
            setattr(jfolder, name, short)
        res = jfolder.fold_ensemble(npz, seq, jax.random.PRNGKey(0),
                                    n_decoys=B, max_iter=args.iters,
                                    x0=jnp.asarray(x0))
        energy = np.asarray(res.energy)
        tors = torch.from_numpy(np.array(res.torsions))
        atoms = {k: np.asarray(v) for k, v in res.atoms.items()}
    wall = time.perf_counter() - t0

    ca = atoms["CA"].astype(np.float64)
    d = np.linalg.norm(np.diff(ca, axis=1), axis=-1)
    ideal = tnerf.build_backbone(tors[:, 0], tors[:, 1], tors[:, 2])
    move = np.linalg.norm(ca - ideal["CA"].numpy(), axis=-1).max(1)
    print(f"{args.package}: L={L} decoys={B} wall {wall:.1f} s")
    print("final centroid energies", energy.tolist())
    print(f"CA-CA min {d.min():.4f} max {d.max():.4f} A")
    print("largest CA move per decoy (A)", np.round(move, 3).tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())

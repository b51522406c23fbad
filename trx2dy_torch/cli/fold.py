"""Single-npz folder CLI on the PyTorch port (trx2dy/cli/fold.py's flags).

    python -m trx2dy_torch.cli.fold -NPZ seq_NMR.npz -FASTA seq.fasta \\
        -OUT decoy.pdb --n_decoys 50 [-r af2|idp|gpcr [-KNOWN k.npz]] \\
        [--no-fastrelax] [--backbone_only] [--device cpu]

Writes OUT for one decoy, or OUT's stem + _k.pdb for each of a batch. With
FastRelax (the default) the PDBs are full-atom: sidechains are packed onto
the fold's (cart-refined) atoms, as the reference dumps its relaxed poses
(folding.py:220,273); --backbone_only or --no-fastrelax write backbone(+CB)
PDBs. --seed seeds the torch.Generator of the torsion init.
"""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Restrained torsion-space folding from geometry npz")
    p.add_argument("-NPZ", type=str, required=True)
    p.add_argument("-FASTA", type=str, required=True)
    p.add_argument("-OUT", type=str, required=True)
    p.add_argument("-pd", type=float, dest="pcut", default=0.05)
    p.add_argument("-m", type=int, dest="mode", default=2,
                   choices=[0, 1, 2, 3])
    p.add_argument("-r", type=str, dest="rst", default="no-idp",
                   choices=["no-idp", "idp", "af2", "gpcr"])
    p.add_argument("-KNOWN", type=str, default=None,
                   help="known-structure npz (gpcr mode)")
    p.add_argument("--orient", dest="use_orient", action="store_true",
                   default=True)
    p.add_argument("--no-orient", dest="use_orient", action="store_false")
    p.add_argument("--fastrelax", dest="fastrelax", action="store_true",
                   default=True)
    p.add_argument("--no-fastrelax", dest="fastrelax", action="store_false")
    p.add_argument("-n", type=int, dest="steps", default=1000)
    p.add_argument("--n_decoys", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backbone_only", action="store_true",
                   help="write backbone(+CB) PDBs, no sidechain packing")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    return p


def main(argv=None):
    """Fold and write the PDBs; returns (paths, FoldResult)."""
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from trx2dy_torch.device import resolve_device
    from trx2dy_torch.io.a3m import read_fasta
    from trx2dy_torch.io.pdbio import write_pdb_backbone
    from trx2dy_torch.physics.folder import fold_ensemble
    from trx2dy_torch.physics.sidechain import pack_and_write

    device = resolve_device(args.device)     # raises before any input is read
    with np.load(args.NPZ) as f:
        npz = dict(f)
    known = None
    if args.KNOWN:
        with np.load(args.KNOWN) as f:
            known = dict(f)
    seq = read_fasta(args.FASTA)
    res = fold_ensemble(npz, seq, torch.Generator().manual_seed(args.seed),
                        n_decoys=args.n_decoys, mode=args.mode,
                        use_orient=args.use_orient, fastrelax=args.fastrelax,
                        pcut=args.pcut, max_iter=args.steps,
                        rst_mode=args.rst, known_npz=known, device=device)
    if args.n_decoys == 1:
        paths = [args.OUT]
    else:
        stem, ext = os.path.splitext(args.OUT)
        paths = [f"{stem}_{b}{ext or '.pdb'}" for b in range(args.n_decoys)]
    if args.fastrelax and not args.backbone_only:
        # relaxed poses are written full-atom; backbone=res.atoms keeps the
        # cartesian-refined coordinates, which the torsions do not hold
        pack_and_write(paths, seq, res.torsions, backbone=res.atoms,
                       device=device)
    else:
        atoms = {k: v.cpu().numpy() for k, v in res.atoms.items()}
        for b, out in enumerate(paths):
            write_pdb_backbone(out, seq, {k: v[b] for k, v in atoms.items()})
    if args.n_decoys == 1:
        print(f"[trx2dy] wrote {args.OUT} (energy {float(res.energy[0]):.1f})")
    else:
        print(f"[trx2dy] wrote {args.n_decoys} decoys")
    return paths, res


if __name__ == "__main__":
    main()

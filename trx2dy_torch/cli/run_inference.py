"""The Dynamics pipeline CLI on the PyTorch port (the flags of
trx2dy/cli/run_inference.py, the reference run_inference.py:356-380, plus
--npz_dir / --model_dir / --seed / --max_iter and the sampler's options).

    python -m trx2dy_torch.cli.run_inference --fasta seq.fasta \\
        --msa seq.a3m --name seq --save_dir out --model_dir models

    python -m trx2dy_torch.cli.run_inference --name_lst names.txt \\
        --fasta_dir fastas --msa_dir msas --save_dir out --model_dir models

--device selects the torch device (default cuda; cpu runs the plain
PyTorch path). The JAX CLI's --aot_cache (its trace cache) has no
counterpart: PyTorch runs eagerly and the port has no capture cache yet.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Protein dynamic-ensemble prediction (trx2dy, PyTorch)")
    p.add_argument("--fasta", type=str, help="single-sample FASTA file")
    p.add_argument("--msa", type=str, help="single-sample MSA (.a3m) file")
    p.add_argument("--fasta_dir", type=str, help="FASTA dir for batch mode")
    p.add_argument("--msa_dir", type=str, help="MSA dir for batch mode")
    p.add_argument("--name", type=str, help="sample name (single mode)")
    p.add_argument("--name_lst", type=str, help="file with names (batch mode)")
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--init_num", type=int, default=10)
    p.add_argument("--Nmax", type=int, default=300)
    p.add_argument("--angle", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--mult_two_models", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    p.add_argument("--npz_dir", type=str, default=None,
                   help="directory with precomputed <name>_{NMR,Xray}.npz")
    p.add_argument("--model_dir", type=str, default=None,
                   help="directory with the Predictor2D weights")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_iter", type=int, default=1000,
                   help="L-BFGS iteration cap per minimization stage")
    p.add_argument("--n_chains", type=int, default=8,
                   help="parallel dampening chains per model, folded as one "
                        "batch per step (1 with --no-combine_models is the "
                        "reference's sequential sampler)")
    p.add_argument("--chain_candidates", type=int, default=None,
                   help="best-of-N candidate lanes folded per chain step. "
                        "An explicit value is honored exactly (the default "
                        "lets the driver raise candidates to fill the lane "
                        "bucket). 1 disables per-step energy gating")
    p.add_argument("--combine_models", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="fold the NMR and X-ray models' chains as one batch "
                        "per step instead of running the two samplers one "
                        "after the other")
    p.add_argument("--len_bucket", type=int, default=None,
                   help="pad targets to multiples of this length (default: "
                        "32 in batch mode, off in single mode)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from trx2dy_torch.device import resolve_device
    from trx2dy_torch.dynamics import driver

    device = resolve_device(args.device)   # raises before any work
    len_bucket = args.len_bucket
    if len_bucket is None:
        len_bucket = 32 if args.name_lst else 0
    extra = {}
    if args.chain_candidates is not None:
        # an explicit value is a contract: the bucket filler may not raise
        # it (only the default opts into filling the bucket)
        extra["chain_candidates"] = args.chain_candidates
        extra["fill_candidates"] = False
        if args.chain_candidates == 1:
            print("[trx2dy] --chain_candidates 1 disables per-step energy "
                  "gating: more decoys per step, measured -0.02 mean TM on "
                  "the bundled example in the JAX package",
                  file=sys.stderr, flush=True)
    cfg = driver.DynamicsConfig(init_num=args.init_num, Nmax=args.Nmax,
                                angle=args.angle,
                                mult_two_models=args.mult_two_models,
                                seed=args.seed, max_iter=args.max_iter,
                                n_chains=args.n_chains,
                                combine_models=args.combine_models,
                                len_bucket=len_bucket, **extra)

    if args.name_lst:
        if not args.fasta_dir or not args.msa_dir:
            raise SystemExit(
                "batch mode requires --fasta_dir, --msa_dir, --name_lst")
        with open(args.name_lst) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        for name in names:
            t0 = time.time()
            driver.run_single(
                name, os.path.join(args.fasta_dir, name + ".fasta"),
                os.path.join(args.msa_dir, name + ".a3m"), args.save_dir,
                cfg, npz_dir=args.npz_dir, model_dir=args.model_dir,
                device=device)
            print(f"[trx2dy] {name} done ({time.time() - t0:.1f}s)",
                  flush=True)
    else:
        if not args.fasta or not args.name:
            raise SystemExit("single mode requires --fasta and --name")
        out = driver.run_single(args.name, args.fasta, args.msa,
                                args.save_dir, cfg, npz_dir=args.npz_dir,
                                model_dir=args.model_dir, device=device)
        print(f"[trx2dy] inference for '{args.name}' completed: {out}")


if __name__ == "__main__":
    main()

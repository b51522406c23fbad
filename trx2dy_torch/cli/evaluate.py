"""Evaluation CLI on the PyTorch port (trx2dy/cli/evaluate.py's flags).

    python -m trx2dy_torch.cli.evaluate -n natives/ -p preds/ \\
        [-o summary.txt|dir] [--align] [--device cpu]

Scores every prediction against every native with the device TM-score
engine and writes the reference's summary.txt (default
pred_dir/summary.txt), byte-identical to the JAX CLI's.
"""
from __future__ import annotations

import argparse
import os
import shutil


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Evaluate predicted structures against natives "
                    "(in-process TM-score engine)")
    p.add_argument("--native_dir", "-n", required=True, type=str)
    p.add_argument("--pred_dir", "-p", required=True, type=str)
    p.add_argument("--output", "-o", type=str, default=None,
                   help="summary file (.txt) or directory "
                        "(default: pred_dir/summary.txt)")
    p.add_argument("--align", action="store_true", default=False,
                   help="match residues by sequence alignment "
                        "(Needleman-Wunsch; TMscore -seq equivalent) "
                        "instead of by residue number")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda)")
    return p


def main(argv=None):
    """Score and write summary.txt; returns run_score's statistics."""
    args = build_parser().parse_args(argv)
    from trx2dy_torch.analysis.evaluate import run_score
    from trx2dy_torch.device import resolve_device

    device = resolve_device(args.device)     # raises before anything is made
    if args.output:
        if args.output.endswith(".txt"):
            out_dir = os.path.dirname(args.output) or os.getcwd()
            summary_path = args.output
        else:
            out_dir = args.output
            summary_path = os.path.join(out_dir, "summary.txt")
        os.makedirs(out_dir, exist_ok=True)
    else:
        out_dir = args.pred_dir
        summary_path = os.path.join(args.pred_dir, "summary.txt")

    stats = run_score(args.native_dir, args.pred_dir, align=args.align,
                      save_summary=True, save_dir=out_dir, device=device)
    min_rmsd, max_tm, mean_rmsd, mean_tm = stats

    default = os.path.join(out_dir, "summary.txt")
    if os.path.abspath(default) != os.path.abspath(summary_path) \
            and os.path.exists(default):
        shutil.move(default, summary_path)

    print("Evaluation Summary:")
    print(f"  Min RMSD: {round(min_rmsd, 3)}")
    print(f"  Max TM-score: {round(max_tm, 3)}")
    print(f"  Mean RMSD: {round(mean_rmsd, 3)}")
    print(f"  Mean TM-score: {round(mean_tm, 3)}")
    print(f"Full summary saved to: {summary_path}")
    return stats


if __name__ == "__main__":
    main()

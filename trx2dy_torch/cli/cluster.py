"""Clustering CLI on the PyTorch port (trx2dy/cli/cluster.py's flags).

    python -m trx2dy_torch.cli.cluster -d decoys/ [-m glocon|tmscore|rmsd] \\
        [-o out/] [--n_clusters 10] [--n_files 5] [--device cpu]

Clusters the decoys of a directory and copies the first n_files of each
cluster into the output directory (default pdb_dir/clusters_result).
"""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Cluster predicted structures (glocon / tmscore / rmsd)")
    p.add_argument("--pdb_dir", "-d", required=True, type=str)
    p.add_argument("--mode", "-m", choices=["glocon", "tmscore", "rmsd"],
                   default="glocon")
    p.add_argument("--output_dir", "-o", type=str, default=None)
    p.add_argument("--n_clusters", type=int, default=10)
    p.add_argument("--n_files", type=int, default=5)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda)")
    return p


def main(argv=None):
    """Cluster and copy; returns save_cluster_result's result."""
    args = build_parser().parse_args(argv)
    from trx2dy_torch.analysis.cluster import save_cluster_result
    from trx2dy_torch.device import resolve_device

    device = resolve_device(args.device)     # raises before anything is made
    output_dir = args.output_dir or os.path.join(args.pdb_dir,
                                                 "clusters_result")
    os.makedirs(output_dir, exist_ok=True)
    result = save_cluster_result(args.pdb_dir, n_clusters=args.n_clusters,
                                 n_files=args.n_files, output_dir=output_dir,
                                 mode=args.mode, device=device)
    if result == "no_cluster":
        print("Clustering failed or not possible.")
    else:
        print(f"Clustering completed. Results saved in {output_dir}.")
    return result


if __name__ == "__main__":
    main()

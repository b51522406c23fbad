"""Checkpoint conversion on the PyTorch port (trx2dy/cli/convert.py's
flags): a torch checkpoint -> a compressed npz of its state_dict.

  python -m trx2dy_torch.cli.convert --in "trX2(NMR)_40.pth" --out nmr.npz
  python -m trx2dy_torch.cli.convert --in esm_msa1_t12_100M_UR50S.pt \\
      --out esm_msa1_t12_100M_UR50S.npz --esm [--bf16]

--esm applies the fairseq upgrade (prefixes stripped, row and column
swapped); --bf16 stores the matrices in bfloat16, norms and biases in
float32 (convert.cast_params). Every loader of the port reads either
format. Conversion runs on the host and needs no card.
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Convert torch weights to npz")
    p.add_argument("--in", dest="inp", required=True,
                   help="torch checkpoint (.pth / .pth.tar / .pt)")
    p.add_argument("--out", required=True, help="output .npz")
    p.add_argument("--esm", action="store_true",
                   help="treat input as a fairseq ESM checkpoint (applies "
                        "the prefix-strip + row/column swap upgrade)")
    p.add_argument("--bf16", action="store_true",
                   help="store matmul weights in bfloat16 (norms stay f32)")
    p.add_argument("--device", type=str, default="cuda",
                   help="checked only: conversion runs on the host; cpu "
                        "where there is no card")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from trx2dy_torch.device import resolve_device
    from trx2dy_torch.models.convert import (
        cast_params, load_state, save_params_npz,
    )

    resolve_device(args.device)
    params = load_state(args.inp, esm=args.esm)
    if args.bf16:
        params = cast_params(params)
    save_params_npz(params, args.out)
    n = sum(int(v.numel()) for v in params.values())
    print(f"[trx2dy] wrote {args.out}: {len(params)} tensors, "
          f"{n / 1e6:.1f}M params")


if __name__ == "__main__":
    main()

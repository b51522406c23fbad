"""The e2e static structure predictor's CLI on the PyTorch port
(trx2dy/cli/predict.py's flags and files, after trRosettaX2/predict.py):
MSA -> ESM-MSA-1b -> recycling Folding -> <model_name>_results.npz,
<model_name>.pdb and plddt.csv.

    python -m trx2dy_torch.cli.predict -i t.a3m -o out/ -mdir models/ \\
        [-mname model_1] [-nrows 500] [-nrec 3] [--row_chunk N] \\
        [--no-bf16] [--device cpu]

-mdir holds the Folding weights (<model_name>.pth.tar, .pth or .npz) and
ESM-MSA-1b's (esm_msa1_t12_100M_UR50S.pt, the fairseq checkpoint, or a
converted .npz; python -m trx2dy_torch.cli.convert). An MSA of more than
1.1 x nrows rows is filtered to filter{nrows}.a3m in the output directory
(hhfilter -diff, reused when present) and its first nrows rows are read.
--bf16 (the default) casts the matrices to bfloat16 with float32 norms
and biases, the reference's autocast.

    python -m trx2dy_torch.cli.predict --arch af2 -i t.a3m -o out/ \
        [-mdir models/ -mname alphafold2 | --random_weights] [--seed N] \
        [-nrec 3] [--no-bf16]

--arch af2 predicts with AlphaFold2, monomer, without templates
(models/alphafold2.py): the a3m's rows and deletion counts are featurized
on the device (the query and 511 centres drawn from --seed, up to 1024
extra rows), then the model with its recycles; it writes
<model_name>_results.npz (plddt, distogram), <model_name>.pdb and
plddt.csv. Its weights are -mdir/<model_name>.npz in the port's keys, or
with --random_weights drawn from --seed (the released parameters are not
converted yet).
"""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="trx2dy e2e structure prediction")
    p.add_argument("-i", "--msa", required=True, help="input MSA (a3m)")
    p.add_argument("-o", "--out_dir", required=True)
    p.add_argument("-mdir", "--model_pth", default="model_pth/trX2_orig")
    p.add_argument("-mname", "--model_name", default="model_1")
    p.add_argument("-nrows", "--nrows", default=500, type=int)
    p.add_argument("-nrec", "--num_recycle", default=3, type=int)
    p.add_argument("--row_chunk", default=None, type=int,
                   help="chunk tied-row attention over this many MSA rows "
                        "(long-MSA memory bound)")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="bf16 matmul weights, norms and biases in f32 (the "
                        "reference's torch.amp.autocast, predict.py:55, "
                        "main_chunk.py:147)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    p.add_argument("--arch", choices=("e2e", "af2"), default="e2e",
                   help="e2e: ESM-MSA-1b and the trRosettaX2 Folding model; "
                        "af2: AlphaFold2 monomer without templates")
    p.add_argument("--seed", type=int, default=0,
                   help="af2: the seed of the cluster draw, and of the "
                        "weights with --random_weights")
    p.add_argument("--random_weights", action="store_true",
                   help="af2: seeded random weights in place of -mdir's")
    return p


def main(argv=None, timings: list = None) -> dict:
    """Predict and write the files; returns the Folding outputs. timings,
    if given, receives (stage, seconds) for the MSA filter, the weights,
    the ESM forward, each cycle's trunk and structure module, and the file
    writing."""
    args = build_parser().parse_args(argv)
    if args.arch == "af2":
        return main_af2(args, timings)
    import numpy as np
    import torch

    from trx2dy_torch.device import StageTimer, resolve_device
    from trx2dy_torch.io.a3m import parse_a3m
    from trx2dy_torch.io.msa_filter import (
        hhfilter_diff_indices, write_filtered_a3m,
    )
    from trx2dy_torch.io.pdbio import write_pdb_atom14
    from trx2dy_torch.models.convert import build_esm, build_folding, \
        load_state
    from trx2dy_torch.models.esm_msa import mymsa_to_esmmsa

    device = resolve_device(args.device)     # raises before any output
    tick = StageTimer(timings, device)
    os.makedirs(args.out_dir, exist_ok=True)
    msa = parse_a3m(args.msa, limit=30000)
    if len(msa) == 1:
        msa = np.concatenate([msa, msa], axis=0)
    if len(msa) > 1.1 * args.nrows:
        # the reference's contract (predict.py:141-147): the filtered MSA
        # is a reusable artifact filter{nrows}.a3m holding hhfilter's whole
        # accepted set (exact=True); the nrows cap is the parse limit
        a3m_filtered = os.path.join(args.out_dir, f"filter{args.nrows}.a3m")
        if not os.path.isfile(a3m_filtered):
            write_filtered_a3m(args.msa, a3m_filtered,
                               hhfilter_diff_indices(msa, args.nrows,
                                                     exact=True))
        msa_filtered = parse_a3m(a3m_filtered, limit=args.nrows)
    else:
        msa_filtered = msa
    with open(args.msa) as f:
        raw_seq = f.readlines()[1].strip().replace("-", "")
    tick("msa_filter")

    esm_file = _find(args.model_pth, "esm_msa1_t12_100M_UR50S",
                     (".pt", ".npz"))
    dtype = torch.bfloat16 if args.bf16 else None
    esm = build_esm(load_state(esm_file, esm=esm_file.endswith(".pt")),
                    device, dtype)
    folding = build_folding(load_state(_find(
        args.model_pth, args.model_name, (".pth.tar", ".pth", ".npz"))),
        device, dtype)
    tick("weights")

    last = len(esm.layers)
    with torch.inference_mode():
        toks = torch.as_tensor(mymsa_to_esmmsa(msa_filtered), device=device)
        emb = esm(toks, repr_layers=(last,), need_head_weights=True,
                  row_chunk=args.row_chunk)
        reprs, attns = emb["representations"][last], emb["row_attentions"]
        if float(reprs.abs().max()) == 0.0 or \
                float(attns.abs().max()) == 0.0:
            # the reference's guard (predict.py:168-169)
            raise ValueError("ESM-MSA fails to generate embeddings! Please "
                             f"check the input MSA file: {args.msa}.")
        tick("esm")
        out = folding(raw_seq, toks, reprs, attns,
                      n_recycle=args.num_recycle, msa_cutoff=args.nrows,
                      timer=tick)

    plddt = out["plddt"].float().cpu().numpy()
    np.savez_compressed(
        os.path.join(args.out_dir, f"{args.model_name}_results.npz"),
        plddt=plddt,
        **{k: v.float().cpu().numpy() for k, v in out["geoms"].items()})
    write_pdb_atom14(os.path.join(args.out_dir, f"{args.model_name}.pdb"),
                     raw_seq, out["atom14"].float().cpu().numpy(),
                     out["atom14_mask"].cpu().numpy(), plddt)
    with open(os.path.join(args.out_dir, "plddt.csv"), "w") as f:
        f.write("Residue_Index,pLDDT\n")
        for i, v in enumerate(plddt):
            # float() upcasts the float32 as pandas does before repr: the
            # digits of the reference's plddt.csv
            f.write(f"{i + 1},{float(v)}\n")
    tick("write")
    print("done!")
    print(f"pLDDT: {float(plddt.mean()):.3f}")
    return out


def main_af2(args, timings: list = None) -> dict:
    """--arch af2: read, weights, predict (models/alphafold2.predict, the
    stages between weights and write), write; returns the host outputs."""
    import numpy as np
    import torch

    from trx2dy_torch.device import StageTimer, resolve_device
    from trx2dy_torch.io.a3m import ALPHABET, parse_a3m_deletions
    from trx2dy_torch.io.pdbio import write_pdb_atom14
    from trx2dy_torch.models.alphafold2 import predict
    from trx2dy_torch.models.convert import (
        build_af2, init_af2_state_dict, load_state,
    )

    device = resolve_device(args.device)     # raises before any output
    tick = StageTimer(timings, device)
    os.makedirs(args.out_dir, exist_ok=True)
    msa, deletion = parse_a3m_deletions(args.msa, limit=30000)
    seq = "".join(ALPHABET[t] for t in msa[0]).replace("-", "X")
    tick("read")
    state = init_af2_state_dict(args.seed) if args.random_weights else \
        load_state(_find(args.model_pth, args.model_name, (".npz",)))
    model = build_af2(state, device,
                      torch.bfloat16 if args.bf16 else None)
    tick("weights")
    host, _ = predict(model, msa, deletion, args.seed, args.num_recycle)
    tick("predict")
    np.savez_compressed(
        os.path.join(args.out_dir, f"{args.model_name}_results.npz"),
        plddt=host["plddt"], distogram=host["distogram"])
    write_pdb_atom14(os.path.join(args.out_dir, f"{args.model_name}.pdb"),
                     seq, host["atom14"], host["atom14_mask"],
                     host["plddt"])
    with open(os.path.join(args.out_dir, "plddt.csv"), "w") as f:
        f.write("Residue_Index,pLDDT\n")
        for i, v in enumerate(host["plddt"]):
            f.write(f"{i + 1},{float(v)}\n")
    tick("write")
    print("done!")
    print(f"pLDDT: {float(host['plddt'].mean()):.3f}")
    return host


def _find(mdir: str, stem: str, exts) -> str:
    for ext in exts:
        path = os.path.join(mdir, stem + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {stem}(.pth.tar/.pth/.pt/.npz) in {mdir}")


if __name__ == "__main__":
    main()

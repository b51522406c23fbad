#!/usr/bin/env python3
"""Readings that set the limits of `correct`, several seeds in one process.

    python3 benchmarks/calibrate.py --workload <cell> --seeds 11,12,... \
        [--seconds 5] [--control-seeds 3] [--faults rows,answer,state] \
        [--fault-seeds 3] [--out chiprun_out/calibrate-<cell>.jsonl]

For each seed it runs the cell as benchmarks/run.py does (set-up, a
window of --seconds, the check) and writes one JSON line: the seed, the
program's numbers against the plain reference, and, for the first
--control-seeds seeds, the control's: the reference computed one
precision below the configuration's (plainref.lowp), compared the same
way. Each planted fault then runs on --fault-seeds seeds. The limits in
benchmarks/limits/ are set between the program's largest reading and
the smallest of the control's (PERF.md says how). Needs the cell's
CUDA device(s); the benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import run as entry

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    entry.setup_paths()
    import torch

    from harness import core, manifest
    from plainref.lowp import CONTROL
    cell = manifest.cell(manifest.load(), args.workload)
    control = CONTROL[cell["config"]["precision"]]
    out = Path(args.out or entry.ROOT / "chiprun_out"
               / f"calibrate-{args.workload}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    jobs = [(s, None, control if i < args.control_seeds else None)
            for i, s in enumerate(seeds)]
    jobs += [(s, f, None) for f in filter(None, args.faults.split(","))
             for s in seeds[:args.fault_seeds]]
    with open(out, "a") as f:
        for seed, fault, ctl in jobs:
            t = time.perf_counter()
            res = core.run(args.workload, seed, args.seconds, False, t,
                           fault=fault, control=ctl)
            line = {"workload": args.workload, "seed": seed, "fault": fault,
                    "control": ctl, "correct": res["correct"],
                    "seconds": time.perf_counter() - t,
                    "attempted": res["attempted"],
                    "metrics": {k: v["value"]
                                for k, v in res["metrics"].items()},
                    "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                    "checks": {k: v["value"]
                               for k, v in res["checks"].items()},
                    "control_checks": {
                        k: v["value"]
                        for k, v in res.get("control_checks", {}).items()}}
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
            f.flush()
            gc.collect()
            torch.cuda.empty_cache()
    found = entry.forbidden_modules()
    if found:
        print(f"calibrate.py: loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run one cell of the benchmark once (see BENCHMARK.json and PERF.md).

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA device(s) the cell
asks for; without them it exits with an error and prints no result. The
last line of standard output is the result: one JSON object with
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), `device`,
with --trace 1 `breakdown`, and last `checks`, each number compared
with its limit (also printed, one per line, as the last lines of
standard error). Nothing is read or written outside the checkout, HOME,
XDG_CACHE_HOME and TMPDIR; the port's kernels build into
build/kernels/ inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "trx2dy")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def setup_paths() -> None:
    """Import the benchmark's packages and the port from the checkout, and
    keep every cache of the run inside it."""
    for p in (str(BENCH), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "triton-cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch-extensions"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    setup_paths()
    from harness import core
    out = core.run(args.workload, args.seed, args.seconds,
                   bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"run.py: the run loaded {found}: the benchmark measures "
              "trx2dy_torch alone", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What a run loads: nothing whose top-level name is jax, jaxlib, flax or
trx2dy (compared whole: trx2dy_torch is the port), and a plain reference
that loads nothing of the port."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from harness import manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]
TINY = {
    "geometry": {"config": {"depth": 1},
                 "traffic": {"length_min": 10, "length_max": 14, "strata": 2,
                             "msa_rows": 16, "sample": 1}},
    "e2e": {"config": {"esm": {"layers": 12, "embed_dim": 24, "heads": 12,
                               "ffn_dim": 48},
                       "folding": {"depth": 1, "in_dim": 2 * 24 + 144 + 962,
                                   "emb_dim": 24,
                                   "sm": {"no_heads_ipa": 2,
                                          "c_resnet": 32}},
                       "recycles": 1, "nrows": 12},
            "traffic": {"length_min": 10, "length_max": 12, "strata": 2,
                        "msa_rows": 12, "sample": 1}},
    "train": {"config": {"depth": 1},
              "traffic": {"length": 12, "msa_rows": 10, "pool": 3,
                          "steps_per_round": 3}},
}

RUN = """
import json, sys, time
sys.path[:0] = [{bench!r}, {root!r}]
import run
run.setup_paths()
from harness import core
out = core.run({cell!r}, 2 ** 31 + 3, 0.05, {trace}, time.perf_counter(),
               allow_cpu=True, overrides={over!r})
print(json.dumps({{"found": run.forbidden_modules(),
                   "port": "trx2dy_torch" in sys.modules,
                   "correct": out["correct"]}}))
"""


def _child(code: str) -> dict:
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    kind = manifest.cell(manifest.load(), cell)["traffic"]["kind"]
    got = _child(RUN.format(bench=str(manifest.BENCH_DIR),
                            root=str(manifest.ROOT), cell=cell, trace=True,
                            over=TINY[kind]))
    assert got["found"] == [] and got["port"]


def test_forbidden_names_compare_whole():
    import run
    sys.modules.setdefault("trx2dy_torch_like_name", sys)
    try:
        assert "trx2dy_torch_like_name" not in run.forbidden_modules()
    finally:
        sys.modules.pop("trx2dy_torch_like_name", None)


def test_reference_loads_nothing_of_the_port():
    code = f"""
import json, sys
sys.path[:0] = [{str(manifest.BENCH_DIR)!r}]
import plainref.esm_msa, plainref.features, plainref.folding, \\
    plainref.lowp, plainref.predictor2d, plainref.structure_module, \\
    plainref.train
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"top": top}}))
"""
    top = set(_child(code)["top"])
    assert not top & {"jax", "jaxlib", "flax", "trx2dy", "trx2dy_torch",
                      "harness"}


def test_reference_imports_by_its_sources():
    allowed = {"torch", "numpy", "plainref", "__future__", "contextlib",
               "functools", "math", "os", "re", "typing"}
    for path in sorted((manifest.BENCH_DIR / "plainref").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path.name, n)

"""The AlphaFold2 cell at a size a test run holds, on the CPU: a run loads
nothing of JAX or the JAX package, a traced run reads the stacks' span
metrics, and the plain reference loads nothing of the port. Its planted
faults and control run in test_bench_faults_every_cell.py."""
from __future__ import annotations

import time

import pytest

from harness import core, manifest
from test_bench_imports import RUN, _child

CELL = "af2-L256-384-m1536"
SEED = 2 ** 31 + 77
# one cycle: at this size the recycled distances' bin flips move the pair
# as far as a fault does, where at the cell's sizes they do not (PERF.md)
TINY = {"config": {"evoformer_blocks": 2, "extra_blocks": 1,
                   "msa_clusters": 8, "extra_msa": 12, "recycles": 0},
        "traffic": {"length_min": 10, "length_max": 14, "strata": 2,
                    "msa_rows": 24, "sample": 1}}


def test_a_run_loads_no_jax():
    got = _child(RUN.format(bench=str(manifest.BENCH_DIR),
                            root=str(manifest.ROOT), cell=CELL, trace=True,
                            over=TINY))
    assert got["found"] == [] and got["port"]


def test_a_traced_run_reads_the_stacks_spans():
    from trx2dy_torch.utils.profiling import collect
    collect()
    out = core.run(CELL, SEED, 0.05, True, time.perf_counter(),
                   allow_cpu=True, overrides=TINY)
    assert out["correct"] is True, out["checks"]
    read = out["metrics"]
    for name in ("evoformer_ms.af2", "extra_msa_ms.af2", "structure_ms.af2"):
        assert read[name]["value"] > 0, name
    wanted = {m["name"] for m in manifest.cell(manifest.load(), CELL)
              ["per_layer"]}
    assert set(read) == {n for n in wanted if "roofline" not in n}
    assert collect() == []      # the readers took the round's spans


def test_reference_loads_nothing_of_the_port():
    code = f"""
import json, sys
sys.path[:0] = [{str(manifest.BENCH_DIR)!r}]
import plainref.alphafold2
print(json.dumps({{"top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""
    top = set(_child(code)["top"])
    assert not top & {"jax", "jaxlib", "flax", "trx2dy", "trx2dy_torch",
                      "harness"}


def test_config_widths_are_the_ports():
    """The configuration's widths are those the port builds by default."""
    from trx2dy_torch.models import af2_features
    from trx2dy_torch.models.alphafold2 import AF2Config
    from trx2dy_torch.models.structure_module import SMConfig
    cfg = manifest.cell(manifest.load(), CELL)["config"]
    assert {k: cfg[k] for k in AF2Config._fields} == AF2Config()._asdict()
    assert cfg["sm"] == SMConfig(c_s=cfg["c_s"], c_z=cfg["c_z"])._asdict()
    assert cfg["input_features"] == {
        "target_feat": af2_features.TARGET_FEAT,
        "msa_feat": af2_features.MSA_FEAT,
        "extra_msa_feat": af2_features.EXTRA_MSA_FEAT}
    assert (cfg["msa_clusters"], cfg["extra_msa"]) == (
        af2_features.MSA_CLUSTERS, af2_features.EXTRA_MSA)

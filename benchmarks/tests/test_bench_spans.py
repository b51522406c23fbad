"""The per-layer metrics that read the program's own spans, on the CPU at
tiny sizes: a traced run reads each as a positive number, and still reads
every per-layer metric it read before (on the CPU the trace holds no
kernel, so the rooflines are left out there, as they were)."""
from __future__ import annotations

import time

import pytest

from harness import core, manifest
from test_bench_imports import TINY

SEED = 2 ** 31 + 91
MAN = manifest.load()
SPAN_METRICS = {m["name"] for m in MAN["per_layer"]
                if m["source"] == "program_span"
                and m["name"].split(".")[0] in (
                    "features_ms", "heads_ms", "output_ms",
                    "structure_host_ms", "forward_ms", "backward_ms",
                    "optimizer_ms")}


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_a_traced_run_reads_every_span_metric(cell):
    from trx2dy_torch.utils.profiling import collect
    collect()
    c = manifest.cell(MAN, cell)
    out = core.run(cell, SEED, 0.05, True, time.perf_counter(),
                   allow_cpu=True, overrides=TINY[c["traffic"]["kind"]])
    assert out["correct"] is True, out["checks"]
    read = out["metrics"]
    wanted = {m["name"] for m in c["per_layer"]}
    new = wanted & SPAN_METRICS
    assert new, "every cell has a metric read from the program's spans"
    for name in new:
        assert read[name]["value"] > 0, name
    assert set(read) == {n for n in wanted if "roofline" not in n}
    assert collect() == []      # the readers took the round's spans

"""test_bench_faults.py's cases for every cell, the af2 kind's among
them: a run with the timed path broken underneath is not `correct`, a
sound run is, and its control (the reference one precision below the
configuration's) fails at least one of the cell's limits. On the CPU at
the sizes test_bench_imports.TINY and test_bench_af2.TINY give.

test_bench_faults.py reads its table of faults by kind when it is
imported, and that table has no af2 entry, so it is not collected while
the af2 cell is in BENCHMARK.json; this module carries its cases until
the table has one."""
from __future__ import annotations

import time

import pytest

from harness import core, manifest
from plainref.lowp import CONTROL
from test_bench_af2 import TINY as AF2_TINY
from test_bench_imports import TINY

SEED = 2 ** 31 + 77
SIZES = dict(TINY, af2=AF2_TINY)
FAULTS = {"geometry": ("answer", "rows"), "e2e": ("answer", "rows"),
          "train": ("state", "rows"), "af2": ("answer", "rows")}
# a deeper geometry trunk than TINY's: at depth 1 and L 10-14 TF32's
# rounding moves the probabilities by less than the limit (PERF.md)
CONTROL_SIZES = dict(SIZES, geometry={
    "config": {"depth": 2},
    "traffic": {"length_min": 24, "length_max": 32, "strata": 2,
                "msa_rows": 40, "sample": 1}})
CELLS = [w["name"] for w in manifest.load()["workloads"]]


def _cell(name):
    c = manifest.cell(manifest.load(), name)
    return c["traffic"]["kind"], c["config"]["precision"]


def _run(cell, fault=None, control=None, sizes=SIZES):
    return core.run(cell, SEED, 0.05, False, time.perf_counter(),
                    allow_cpu=True, fault=fault,
                    overrides=sizes[_cell(cell)[0]], control=control)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[_cell(c)[0]]])
def test_a_planted_fault_is_not_correct(cell, fault):
    out = _run(cell, fault=fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_its_control_is_not(cell):
    out = _run(cell, control=CONTROL[_cell(cell)[1]], sizes=CONTROL_SIZES)
    assert out["correct"] is True, out["checks"]
    ctl = out["control_checks"]
    assert any(v["value"] > v["limit"] for v in ctl.values()), ctl

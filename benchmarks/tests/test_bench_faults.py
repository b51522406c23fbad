"""A run with the timed path broken underneath, on the CPU at a size a
test run holds: `correct` has to come out false for every fault a cell
can have, true for a sound run, and the control (the reference one
precision below the configuration's) has to fail at least one of the
cell's limits."""
from __future__ import annotations

import time

import pytest

from harness import core, manifest
from plainref.lowp import CONTROL
from test_bench_imports import TINY

SEED = 2 ** 31 + 77
FAULTS = {"geometry": ("answer", "rows"), "e2e": ("answer", "rows"),
          "train": ("state", "rows")}


def _cell(name):
    c = manifest.cell(manifest.load(), name)
    return c["traffic"]["kind"], c["config"]["precision"]


# a deeper geometry trunk than TINY's: at depth 1 and L 10-14 TF32's
# rounding moves the probabilities by less than the limit (PERF.md)
CONTROL_SIZE = dict(TINY, geometry={
    "config": {"depth": 2},
    "traffic": {"length_min": 24, "length_max": 32, "strata": 2,
                "msa_rows": 40, "sample": 1}})


def _run(cell, fault=None, control=None, sizes=TINY):
    kind, _ = _cell(cell)
    return core.run(cell, SEED, 0.05, False, time.perf_counter(),
                    allow_cpu=True, fault=fault, overrides=sizes[kind],
                    control=control)


CASES = [(w["name"], f) for w in manifest.load()["workloads"]
         for f in FAULTS[_cell(w["name"])[0]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    out = _run(cell, fault=fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_a_sound_run_is_correct_and_its_control_is_not(cell):
    out = _run(cell, control=CONTROL[_cell(cell)[1]], sizes=CONTROL_SIZE)
    assert out["correct"] is True, out["checks"]
    ctl = out["control_checks"]
    assert any(v["value"] > v["limit"] for v in ctl.values()), ctl


@pytest.mark.gpu
def test_geometry_on_the_card_is_correct_and_a_fault_is_not(cuda):
    cell = "geometry-L160-400-r1000"
    assert _run_on(cell, None)["correct"] is True
    assert _run_on(cell, "answer")["correct"] is False


def _run_on(cell, fault):
    kind, _ = _cell(cell)
    return core.run(cell, SEED, 0.05, False, time.perf_counter(),
                    fault=fault, overrides=TINY[kind])

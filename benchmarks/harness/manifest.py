"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) joins a configuration and a traffic mix.
Everything that belongs to one of them sits in files of its own:

- configuration: the file that BENCHMARK.json's `configs` entry names
  (benchmarks/configs/<config>.json): sizes, precision, source;
- traffic mix: benchmarks/traffic/<traffic>.json, the parameters of the
  generator; its "kind" names the driver, benchmarks/kinds/<kind>.py;
- the limits of `correct` for a cell: benchmarks/limits/<cell>.json;
- a per-layer metric: its reader, benchmarks/metrics/<metric>.py, with a
  function read(ctx) that returns a number or None.

So a later change adds a cell, a mix, a configuration or a metric as new
files, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a file by path under a private module name."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(manifest: dict, name: str) -> dict:
    """The resolved cell: its entry, configuration, traffic, limits, the
    end-to-end metrics it reports and its per-layer metrics."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return {
        "name": name, "entry": w, "chips": w["chips"],
        "config": _read_json(ROOT / cfg_entry["file"]),
        "traffic": _read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        "limits": _read_json(BENCH_DIR / "limits" / f"{name}.json"),
        "end_to_end": e2e, "per_layer": per_layer,
    }


def kind(traffic: dict):
    """The driver module that the traffic's "kind" names."""
    k = traffic["kind"]
    return load_module(BENCH_DIR / "kinds" / f"{k}.py", f"bench_kind_{k}")


def reader(metric: str):
    """The reader module of a per-layer metric."""
    return load_module(BENCH_DIR / "metrics" / f"{metric}.py",
                       "bench_metric_" + metric.replace(".", "_"))

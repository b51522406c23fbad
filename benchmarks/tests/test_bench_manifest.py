"""BENCHMARK.json against the contract, and the files it names."""
from __future__ import annotations

import json
import re

import pytest

from harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH_KEY = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                       r"proj|head|expan|experts_per")

MAN = manifest.load()
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmarks/run.py"]
    assert MAN["paths"] == ["benchmarks"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in MAN["configs"]] + CELLS \
        + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]] \
        + [w["traffic"] for w in MAN["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_one_line_fields():
    texts = [c["why"] for c in MAN["configs"]] \
        + [c["source"] for c in MAN["configs"]] \
        + [w["why"] for w in MAN["workloads"]] \
        + [m["layer"] for m in MAN["per_layer"]]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_bounds_and_sources():
    names = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in names
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_present(cell):
    c = manifest.cell(MAN, cell)
    assert c["chips"] == 1
    assert c["traffic"]["kind"]
    assert (manifest.BENCH_DIR / "kinds" / f"{c['traffic']['kind']}.py") \
        .exists()
    assert c["limits"], "every cell has limits for its checks"
    for m in c["end_to_end"] + c["per_layer"]:
        assert hasattr(manifest.reader(m["name"]), "read"), m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_its_metrics_move(cell):
    c = manifest.cell(MAN, cell)
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"], "every cell reports a per-layer metric"
    for m in c["per_layer"]:
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_configs_named_once_and_used():
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmarks/")
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert not WIDTH_KEY.search(key), key


def test_config_widths_are_the_ports():
    """The configurations' widths are those the port builds by default."""
    from trx2dy_torch.models import esm_msa, predictor2d
    from trx2dy_torch.models.folding_e2e import E2E_IN_DIM, N_ESM_TOKENS
    from trx2dy_torch.models.structure_module import SMConfig
    p2d = json.loads((manifest.BENCH_DIR / "configs"
                      / "trx2-predictor2d.json").read_text())
    assert (p2d["dim"], p2d["depth"], p2d["heads"], p2d["dim_head"],
            p2d["tri_heads"], p2d["tri_dim_head"], p2d["in_dim"],
            p2d["n_tokens"], p2d["res2_width"]) == (
        predictor2d.DIM, predictor2d.DEPTH, predictor2d.HEADS,
        predictor2d.DIM_HEAD, predictor2d.TRI_HEADS,
        predictor2d.TRI_DIM_HEAD, predictor2d.IN_DIM, predictor2d.N_TOKENS,
        predictor2d.RES2_WIDTH)
    e2e = json.loads((manifest.BENCH_DIR / "configs"
                      / "trx2-e2e-esm1b.json").read_text())
    assert e2e["esm"] == {"layers": esm_msa.LAYERS,
                          "embed_dim": esm_msa.EMBED_DIM,
                          "heads": esm_msa.HEADS, "ffn_dim": esm_msa.FFN_DIM,
                          "vocab": esm_msa.VOCAB,
                          "max_positions": esm_msa.MAX_POSITIONS,
                          "max_rows": esm_msa.MAX_ROWS}
    assert e2e["folding"]["in_dim"] == E2E_IN_DIM
    assert e2e["folding"]["n_tokens"] == N_ESM_TOKENS
    assert e2e["folding"]["sm"] == SMConfig()._asdict()


def test_per_layer_metrics_name_their_cells():
    for m in MAN["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for k, v in layers.items()
               if k not in ("mfu",)), layers


def test_four_chip_cells_within_a_quarter():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(CELLS) // 4)

"""AlphaFold2 on the port (models/alphafold2.py, models/af2_features.py,
the triangle-attention core's rows argument, predict --arch af2) against
the benchmark's plain reference (benchmarks/plainref/alphafold2.py) and
direct einsums, on the CPU.

Sizes: L = 20, 40 MSA rows featurized into 16 clusters and 24 extra rows,
2 Evoformer blocks and 1 extra-MSA block at the published widths, 2
cycles, seeded random float32 weights. The port and the reference compute
the same function in float32, so outputs agree to float32 rounding:
within 1e-5 of each output's largest magnitude (measured 1e-7 to 2e-6;
the structure module's coordinates compound the stacks' rounding).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from trx2dy_torch.cli import predict as predict_cli
from trx2dy_torch.io.a3m import ALPHABET, parse_a3m, parse_a3m_deletions
from trx2dy_torch.models import af2_features
from trx2dy_torch.models.alphafold2 import (
    AF2_STATS, AF2Config, MSAColumnGlobalAttention, OuterProductMean,
    predict,
)
from trx2dy_torch.models.convert import (
    af2_config_of, build_af2, init_af2_state_dict,
)
from trx2dy_torch.ops.triangle_attention import (
    _check, tri_attn_core, tri_attn_core_plain,
)

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from plainref import alphafold2 as ref  # noqa: E402

torch.set_num_threads(2)

L, ROWS, CLUSTERS, EXTRA, SEED = 20, 40, 16, 24, 7
CFG = AF2Config(evoformer_blocks=2, extra_blocks=1)
REL_TOL = 1e-5


def _msa(rows=ROWS, length=L, seed=0):
    rng = np.random.default_rng(seed)
    msa = rng.integers(0, 21, (rows, length)).astype(np.uint8)
    msa[0] = rng.integers(0, 20, length)
    dels = np.where(rng.random((rows, length)) < 0.2,
                    rng.integers(1, 4, (rows, length)), 0)
    dels[0] = 0
    return msa, dels


@pytest.fixture(scope="module")
def outputs():
    state = init_af2_state_dict(3, CFG)
    model = build_af2(state, "cpu")
    want_model = ref.AlphaFold2(evoformer_blocks=2, extra_blocks=1).eval()
    want_model.load_state_dict(state)
    msa, dels = _msa()
    AF2_STATS.reset()
    host, got = predict(model, msa, dels, SEED, 1, CLUSTERS, EXTRA)
    stats = (dict(AF2_STATS.launches), AF2_STATS.global_col)
    with torch.no_grad():
        want = ref.predict(want_model, msa, dels, SEED, 1, CLUSTERS, EXTRA,
                           "cpu")
    return host, got, want, stats


@pytest.mark.parametrize("key", ["msa_first_row", "pair", "distogram",
                                 "plddt", "atom14"])
def test_model_matches_the_plain_reference(outputs, key):
    _, got, want, _ = outputs
    assert got[key].shape == want[key].shape
    gap = (got[key] - want[key]).abs().max().item()
    assert gap <= REL_TOL * max(1.0, want[key].abs().max().item()), gap


@pytest.mark.parametrize("key", ["atom14", "atom14_mask", "plddt",
                                 "distogram"])
def test_predict_copies_the_outputs_to_the_host(outputs, key):
    host, got, _, _ = outputs
    assert isinstance(host[key], np.ndarray)
    np.testing.assert_array_equal(host[key], got[key].numpy())


def test_stats_count_global_attention_and_no_launch_on_the_cpu(outputs):
    launches, global_col = outputs[3]
    assert launches == {"msa_row": 0, "tri_start": 0, "tri_end": 0}
    assert global_col == CFG.extra_blocks * 2


@pytest.mark.parametrize("key", ["target_feat", "msa_feat", "extra_msa_feat",
                                 "aatype"])
@pytest.mark.parametrize("rows,clusters", [(ROWS, CLUSTERS), (12, 16)])
def test_features_match_the_reference(key, rows, clusters):
    msa, dels = _msa(rows)
    got = af2_features.featurize(msa, dels, SEED, clusters, EXTRA, "cpu")
    want = ref.features(msa, dels, SEED, clusters, EXTRA, "cpu")
    assert got[key].shape == want[key].shape
    torch.testing.assert_close(got[key].float(), want[key].float(), rtol=0,
                               atol=1e-6)


def test_features_widths_and_profile():
    msa, dels = _msa()
    f = af2_features.featurize(msa, dels, SEED, CLUSTERS, EXTRA, "cpu")
    assert f["msa_feat"].shape == (CLUSTERS, L, 49)
    assert f["extra_msa_feat"].shape == (EXTRA, L, 25)
    assert f["target_feat"].shape == (L, 22)
    order = af2_features.cluster_order(ROWS, SEED)
    assert order[0] == 0 and sorted(order.tolist()) == list(range(ROWS))
    # the query is centre 0; profiles are distributions over 23 tokens
    gap = torch.as_tensor(msa[0] == 20)
    np.testing.assert_array_equal(f["msa_feat"][0, :, :23].argmax(-1),
                                  np.where(gap, 21, msa[0]))
    torch.testing.assert_close(f["msa_feat"][..., 25:48].sum(-1),
                               torch.ones(CLUSTERS, L))


def _global_direct(mod, m):
    S, Lm, _ = m.shape
    H, D = mod.heads, mod.head_dim
    x = torch.nn.functional.layer_norm(m, (m.shape[-1],), mod.norm_m.weight,
                                       mod.norm_m.bias, 1e-5)
    q = torch.einsum("slc,ec->sle", x, mod.to_q.weight).mean(0)
    q = q.reshape(Lm, H, D) / D ** 0.5
    kv = torch.einsum("slc,ec->sle", x, mod.to_kv.weight)
    k, v = kv[..., :D], kv[..., D:]
    a = torch.softmax(torch.einsum("lhd,sld->lhs", q, k), -1)
    o = torch.einsum("lhs,sld->lhd", a, v)
    g = torch.sigmoid(torch.einsum("slc,ec->sle", x, mod.to_gate.weight)
                      + mod.to_gate.bias).reshape(S, Lm, H, D)
    return torch.einsum("sle,ce->slc", (g * o).reshape(S, Lm, H * D),
                        mod.to_out.weight) + mod.to_out.bias


def _opm_direct(mod, m):
    S, Lm, _ = m.shape
    x = torch.nn.functional.layer_norm(m, (m.shape[-1],), mod.norm.weight,
                                       mod.norm.bias, 1e-5)
    a = torch.einsum("slc,ec->sle", x, mod.linear_a.weight) \
        + mod.linear_a.bias
    b = torch.einsum("slc,ec->sle", x, mod.linear_b.weight) \
        + mod.linear_b.bias
    o = torch.einsum("sic,sjd->ijcd", a, b) / S
    return torch.einsum("ije,ke->ijk", o.reshape(Lm, Lm, -1),
                        mod.linear_out.weight) + mod.linear_out.bias


@pytest.mark.parametrize("op", ["global_column_attention",
                                "outer_product_mean"])
def test_msa_ops_against_direct_einsums(op):
    torch.manual_seed(4)
    if op == "global_column_attention":
        mod, direct = MSAColumnGlobalAttention(64, 8, 8), _global_direct
        m = torch.randn(9, 11, 64)
    else:
        mod, direct = OuterProductMean(32, 16, 8), _opm_direct
        m = torch.randn(7, 10, 32)
    for p in mod.parameters():
        torch.nn.init.normal_(p, 0.0, 0.3)
    with torch.no_grad():
        torch.testing.assert_close(mod(m), direct(mod, m), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("R", [1, 5, 13])
def test_plain_core_takes_rows_other_than_positions(R):
    n, H, D = 9, 8, 32
    gen = torch.Generator().manual_seed(R)
    q, k, v = (torch.randn(R, n, H, D, generator=gen) for _ in range(3))
    bias = torch.randn(n, n, H, generator=gen)
    got = tri_attn_core_plain(q, k, v, bias, "row")
    for r in range(R):
        s = torch.einsum("ihd,jhd->ijh", q[r], k[r]) / D ** 0.5 + bias
        want = torch.einsum("ijh,jhd->ihd", torch.softmax(s, dim=1), v[r])
        torch.testing.assert_close(got[r], want, rtol=1e-5, atol=1e-5)
    assert torch.equal(tri_attn_core(q, k, v, bias, "row"), got)


@pytest.mark.parametrize("case", ["three_axes", "head_width", "bias_shape",
                                  "column_rows", "empty"])
def test_check_refuses_bad_shapes(case):
    q = torch.zeros(5, 9, 8, 32)
    bias = torch.zeros(9, 9, 8)
    wise = "row"
    if case == "three_axes":
        q = q[0]
    elif case == "head_width":
        q = torch.zeros(5, 9, 8, 16)
    elif case == "bias_shape":
        bias = torch.zeros(5, 9, 8)
    elif case == "column_rows":
        wise = "col"
    else:
        q = torch.zeros(0, 9, 8, 32)
    with pytest.raises(ValueError, match="must be"):
        _check(q, q, q, bias, wise)


def test_rows_other_than_positions_reach_the_device_check():
    q = torch.zeros(5, 9, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        _check(q, q, q, torch.zeros(9, 9, 8))


def test_deletion_parser(tmp_path):
    path = tmp_path / "t.a3m"
    path.write_text(">q\nACDE\n>a\nAaaCD-\n>b\nACbDEc\n>c\nACD\n")
    msa, dels = parse_a3m_deletions(str(path))
    tokens = [[ALPHABET.index(c) for c in row]
              for row in ("ACDE", "ACD-", "ACDE")]
    np.testing.assert_array_equal(msa, tokens)
    np.testing.assert_array_equal(parse_a3m(str(path)), tokens)
    np.testing.assert_array_equal(dels, [[0, 0, 0, 0], [0, 2, 0, 0],
                                         [0, 0, 1, 0]])


def test_config_reads_back_from_the_state():
    assert af2_config_of(init_af2_state_dict(0, CFG)) == CFG


def _write_a3m(path, msa):
    with open(path, "w") as f:
        for n, row in enumerate(msa):
            f.write(f">s{n}\n{''.join(ALPHABET[t] for t in row)}\n")


def test_predict_cli_runs_af2_through_its_stages(tmp_path, monkeypatch):
    from trx2dy_torch.models import alphafold2
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[1:4])
        return predict(*args, **kwargs)
    monkeypatch.setattr(alphafold2, "predict", spy)
    msa, _ = _msa(30, 12)
    a3m = tmp_path / "t.a3m"
    _write_a3m(a3m, msa)
    timings = []
    host = predict_cli.main(
        ["--arch", "af2", "-i", str(a3m), "-o", str(tmp_path / "out"),
         "--random_weights", "--seed", "5", "-nrec", "0", "--no-bf16",
         "--device", "cpu"], timings)
    assert [t[0] for t in timings] == ["read", "weights", "predict",
                                       "write"]
    # the CLI's predict stage is models/alphafold2.predict, as the
    # benchmark's kind calls it
    (got_msa, got_del, seed), = calls
    np.testing.assert_array_equal(got_msa, msa)
    assert not got_del.any() and seed == 5
    for name in ("model_1_results.npz", "model_1.pdb", "plddt.csv"):
        assert (tmp_path / "out" / name).exists()
    saved = np.load(tmp_path / "out" / "model_1_results.npz")
    np.testing.assert_array_equal(saved["distogram"], host["distogram"])
    np.testing.assert_array_equal(saved["plddt"], host["plddt"])


def test_predict_cli_af2_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_cli.main(["--arch", "af2", "-i", "t.a3m", "-o",
                          str(tmp_path / "out"), "--random_weights"])
    assert not (tmp_path / "out").exists()


@pytest.mark.gpu
def test_kernel_takes_msa_rows_on_the_card():
    """The Evoformer's MSA-row launch at R = 512, L = 96, H = 8 against the
    plain path in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU takes the plain version")
    R, n, H, D = 512, 96, 8, 32
    gen = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(R, n, H, D, generator=gen).cuda()
               for _ in range(3))
    bias = torch.randn(H, n, n, generator=gen).cuda().permute(1, 2, 0)
    before = tri_attn_core.launches
    with torch.inference_mode():
        got = tri_attn_core(q, k, v, bias, "row")
    assert tri_attn_core.launches == before + 1
    want = tri_attn_core_plain(q.double(), k.double(), v.double(),
                               bias.double(), "row")
    assert (got.double() - want).abs().max().item() < 1e-5

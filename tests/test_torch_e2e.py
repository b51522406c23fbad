"""The port's e2e static predictor against the JAX package's, on the CPU:
Folding, the hhfilter -diff filter, the ESM checkpoint upgrade, the weight
carry with bf16 weights, and python -m trx2dy_torch.cli.predict.

Folding runs at trunk depth 1, 2 structure-module blocks with 2 IPA heads,
1 recycle, L = 12, on seeded random weights and seeded ESM outputs.
Tolerances:
  - float32: probabilities and pLDDT within 1e-4 absolute; atom14
    coordinates within 1e-2 Å (measured 2e-5; the structure module
    compounds the trunk's rounding over its blocks);
  - bf16 weights: the port's distance from JAX in float32 is at most
    max(1.5 x JAX-bf16's own distance from JAX-f32, 1e-3), per output.
    The port upcasts the triangle attention core to float32 where JAX
    runs it in bf16, so it is the closer of the two there.
The filter's indices are identical and filter{n}.a3m is byte-identical.
"""
import argparse
import os
import pickle

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import trx2dy.models.esm_msa as jesm
from trx2dy.io import msa_filter as jfilter
from trx2dy.io.a3m import parse_a3m as jparse_a3m
from trx2dy.models.folding_e2e import folding_apply
from trx2dy.models.predictor2d import cast_params as jcast_params
from trx2dy.models.torch_convert import (
    load_esm_checkpoint, save_params_npz as jsave_params_npz,
)
from trx2dy_torch.cli import predict as predict_cli
from trx2dy_torch.io import msa_filter as tfilter
from trx2dy_torch.io.a3m import ALPHABET
from trx2dy_torch.models import convert
from trx2dy_torch.models.esm_msa import mymsa_to_esmmsa
from trx2dy_torch.models.folding_e2e import E2E_IN_DIM
from trx2dy_torch.models.structure_module import SMConfig

torch.set_num_threads(2)

SEQ = "ARNDCQEGHILK"
L = len(SEQ)
SM = SMConfig(no_heads_ipa=2, c_resnet=32)
F32_TOL, COORD_TOL = 1e-4, 1e-2
KEYS = {"dist": 37, "omega": 25, "theta": 25, "phi": 13}


def _folding_weights(seed, emb_dim=768):
    in_dim = E2E_IN_DIM - 2 * (768 - emb_dim)
    return convert.init_folding_state_dict(seed, depth=1, in_dim=in_dim,
                                           emb_dim=emb_dim, sm=SM)


def _esm_inputs(R, seed):
    rng = np.random.default_rng(seed)
    msa = rng.integers(0, 21, (R, L))
    msa[1:R // 2] = np.where(rng.random((R // 2 - 1, L)) < 0.2,
                             rng.integers(0, 21, (R // 2 - 1, L)), msa[0])
    toks = mymsa_to_esmmsa(msa)
    reprs = rng.normal(size=(R, L + 1, 768)).astype(np.float32)
    attn = rng.random((12, 12, L + 1, L + 1)).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    return toks, reprs, attn


def _outputs(o):
    get = (lambda t: t.float().numpy()) if torch.is_tensor(o["plddt"]) \
        else (lambda t: np.asarray(t, np.float32))
    out = {k: get(v) for k, v in o["geoms"].items()}
    out.update(plddt=get(o["plddt"]), atom14=get(o["atom14"]))
    return out


@pytest.fixture(scope="module")
def folding_case():
    w = _folding_weights(1)
    toks, reprs, attn = _esm_inputs(6, seed=2)
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    jargs = (SEQ, jnp.asarray(toks), jnp.asarray(reprs), jnp.asarray(attn))
    kw = dict(n_recycle=1, sm_blocks=2, trunk_depth=1)
    ref32 = _outputs(folding_apply(jp, *jargs, **kw))
    ref16 = _outputs(folding_apply(jcast_params(jp), *jargs, **kw))
    ref_xrec = _outputs(folding_apply(jp, *jargs, coord_recycling=True,
                                      **kw))
    return w, (toks, reprs, attn), kw, ref32, ref16, ref_xrec


def _port(w, inputs, kw, dtype):
    model = convert.build_folding({k: torch.from_numpy(v)
                                   for k, v in w.items()}, "cpu", dtype)
    toks, reprs, attn = (torch.from_numpy(a) for a in inputs)
    with torch.inference_mode():
        return _outputs(model(SEQ, toks, reprs, attn, **kw))


@pytest.mark.parametrize("coord_recycling", [False, True])
def test_folding_f32_matches_jax(folding_case, coord_recycling):
    """coord_recycling=True feeds cycle 0's CA coordinates to cycle 1's
    recycling embedder; False (the reference's) feeds zeros every cycle."""
    w, inputs, kw, ref32, _, ref_xrec = folding_case
    got = _port(w, inputs, dict(kw, coord_recycling=coord_recycling), None)
    if coord_recycling:
        # the switch changes the result, so the comparison tests it
        assert np.abs(ref_xrec["dist"] - ref32["dist"]).max() > 10 * F32_TOL
        ref32 = ref_xrec
    for key, n in KEYS.items():
        assert got[key].shape == (L, L, n)
        assert np.abs(got[key] - ref32[key]).max() < F32_TOL, key
    assert np.abs(got["plddt"] - ref32["plddt"]).max() < F32_TOL
    assert np.abs(got["atom14"] - ref32["atom14"]).max() < COORD_TOL


def test_folding_bf16_within_jax_bf16_band(folding_case):
    w, inputs, kw, ref32, ref16, _ = folding_case
    got = _port(w, inputs, kw, torch.bfloat16)
    for key in list(KEYS) + ["plddt", "atom14"]:
        own = np.abs(ref16[key] - ref32[key]).max()
        dist = np.abs(got[key] - ref32[key]).max()
        assert dist <= max(1.5 * own, 1e-3), (key, dist, own)
    # the cast did something: bf16 is not the float32 result
    assert np.abs(got["dist"] - ref32["dist"]).max() > 0


# --------------------------------------------------------------- msa filter

def _msa(n, L_, seed, gaps=0.1):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 20, L_)
    rate = rng.uniform(0.05, 0.8, (n, 1))
    m = np.where(rng.random((n, L_)) < rate, rng.integers(0, 20, (n, L_)), q)
    m = np.where(rng.random((n, L_)) < gaps, 20, m)
    m[0] = q
    return m


FILTER_CASES = {
    "diverse": (_msa(120, 70, 1), 30, {}),
    "exact": (_msa(120, 70, 2), 30, {"exact": True}),
    "redundant": (np.vstack([np.tile(_msa(1, 30, 3), (40, 1)),
                             _msa(3, 30, 4)[1:]]), 8, {}),
    "gappy_blocks": (_msa(80, 120, 5, gaps=0.6), 20, {"exact": True}),
}


@pytest.mark.parametrize("case", list(FILTER_CASES))
def test_msa_filter_indices_match_jax(case):
    msa, n, kw = FILTER_CASES[case]
    got = tfilter.hhfilter_diff_indices(msa, n, **kw)
    assert np.array_equal(got, jfilter.hhfilter_diff_indices(msa, n, **kw))
    assert np.array_equal(tfilter.filter_msa_diff(msa, n),
                          jfilter.filter_msa_diff(msa, n))
    assert np.array_equal(tfilter.hhfilter_equivalent(msa, n),
                          jfilter.hhfilter_equivalent(msa, n))


def _write_a3m(path, msa, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i, row in enumerate(msa):
            s = "".join(ALPHABET[t] for t in row)
            if i % 7 == 3:                 # a lowercase insertion
                s = s[:5] + "ga" + s[5:]
            if i % 11 == 5:                # a wrong-length row, skipped
                s = s[:-2]
            f.write(f">s{i} {rng.integers(1000)}\n{s}\n")


def test_filtered_a3m_byte_identical(tmp_path):
    msa = _msa(90, 40, 6)
    src = tmp_path / "in.a3m"
    _write_a3m(src, msa)
    parsed = jparse_a3m(str(src), limit=30000)
    idx = tfilter.hhfilter_diff_indices(parsed, 20, exact=True)
    tfilter.write_filtered_a3m(str(src), str(tmp_path / "port.a3m"), idx)
    jfilter.write_filtered_a3m(str(src), str(tmp_path / "jax.a3m"),
                               jfilter.hhfilter_diff_indices(parsed, 20,
                                                             exact=True))
    assert (tmp_path / "port.a3m").read_bytes() == \
        (tmp_path / "jax.a3m").read_bytes()


# ------------------------------------------------------ weights and upgrade

def test_esm_checkpoint_upgrade_matches_jax(tmp_path):
    """A fairseq-format dict: 'encoder.sentence_encoder.' / 'encoder.'
    prefixes and row <-> column swapped names."""
    sd = convert.init_esm_state_dict(0, layers=1, embed_dim=8, heads=2,
                                     ffn_dim=16)
    swap = {"row": "column", "column": "row"}

    def fairseq(k):
        for a, b in swap.items():
            if a in k:
                k = k.replace(a, b)
                break
        return ("encoder.sentence_encoder." if k.startswith("layers.")
                else "encoder.") + k
    path = tmp_path / "esm.pt"
    torch.save({"model": {fairseq(k): torch.from_numpy(v)
                          for k, v in sd.items()},
                "args": argparse.Namespace(arch="msa_transformer", layers=1)},
               path)
    got = convert.load_state(str(path), esm=True)
    ref = load_esm_checkpoint(str(path))
    assert got.keys() == ref.keys() == sd.keys()
    for k, v in got.items():
        assert np.array_equal(v.numpy(), np.asarray(ref[k]))
    # a plain (already upgraded) state_dict passes through
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "plain.pt")
    assert convert.load_state(str(tmp_path / "plain.pt"),
                              esm=True).keys() == sd.keys()


def test_bf16_weights_stay_bf16(tmp_path):
    w = {k: torch.from_numpy(v) for k, v in _folding_weights(3, 16).items()}
    cast = convert.cast_params(w)
    ref = jcast_params({k: jnp.asarray(v.numpy()) for k, v in w.items()})
    for k, v in cast.items():          # the same rule as JAX's
        assert str(v.dtype).split(".")[-1] == str(ref[k].dtype), k
    # an npz round trip, and the JAX package's own bf16 npz, keep the bits
    convert.save_params_npz(cast, str(tmp_path / "port.npz"))
    jsave_params_npz(ref, str(tmp_path / "jax.npz"))
    for name in ("port.npz", "jax.npz"):
        back = convert.load_params_npz(str(tmp_path / name))
        assert all(torch.equal(back[k], cast[k]) for k in cast)
    model = convert.build_folding(back, "cpu")
    assert model.net2d.conv1.weight.dtype == torch.bfloat16
    assert model.structure_module.ipa.linear_q.weight.dtype == torch.bfloat16
    assert model.net2d.conv1.bias.dtype == torch.float32
    assert model.net2d.bn1.weight.dtype == torch.float32
    model = convert.build_folding(w, "cpu", torch.bfloat16)
    assert model.net2d.net.blocks[0][0].pair_row_attn.to_qkv.weight.dtype \
        == torch.bfloat16


class _Payload:
    """Stands for an object that a malicious checkpoint would unpickle."""

    def __reduce__(self):
        return (os.getcwd, ())


@pytest.mark.parametrize("esm", [False, True])
def test_load_state_refuses_arbitrary_objects(tmp_path, esm):
    """Checkpoints are read with the weights-only unpickler: an object
    other than tensors, containers and fairseq's argparse.Namespace is
    refused before it is built."""
    path = tmp_path / "bad.pt"
    torch.save({"model": {"w": torch.zeros(2)}, "extra": _Payload()}, path)
    with pytest.raises(pickle.UnpicklingError, match="weights_only"):
        convert.load_state(str(path), esm=esm)


# ------------------------------------------------------------- the CLI

TINY_ESM = dict(layers=12, embed_dim=24, heads=12, ffn_dim=48)


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict")
    mdir = root / "models"
    mdir.mkdir()
    esm = convert.init_esm_state_dict(4, **TINY_ESM)
    fold = _folding_weights(5, TINY_ESM["embed_dim"])
    convert.save_params_npz(esm, str(mdir / "esm_msa1_t12_100M_UR50S.npz"))
    torch.save({k: torch.from_numpy(v) for k, v in fold.items()},
               mdir / "model_1.pth.tar")
    a3m = root / "t.a3m"
    msa = _msa(40, L, 7)
    msa[0] = [ALPHABET.index(c) for c in SEQ]
    _write_a3m(a3m, msa)
    return root, mdir, a3m, esm, fold


def _jax_predict(a3m_filtered, esm, fold, nrows, n_recycle, monkeypatch):
    for name, value in (("EMBED_DIM", TINY_ESM["embed_dim"]),
                        ("HEADS", TINY_ESM["heads"]),
                        ("HEAD_DIM", TINY_ESM["embed_dim"]
                         // TINY_ESM["heads"])):
        monkeypatch.setattr(jesm, name, value)
    msa = jparse_a3m(str(a3m_filtered), limit=nrows)
    toks = jnp.asarray(jesm.mymsa_to_esmmsa(msa))
    emb = jesm.esm_msa_apply({k: jnp.asarray(v) for k, v in esm.items()},
                             toks)
    return _outputs(folding_apply(
        {k: jnp.asarray(v) for k, v in fold.items()}, SEQ, toks,
        emb["representations"][12], emb["row_attentions"],
        n_recycle=n_recycle, msa_cutoff=nrows, trunk_depth=1))


def test_cli_predict_matches_jax(cli_case, monkeypatch, capsys):
    root, mdir, a3m, esm, fold = cli_case
    out = root / "f32"
    timings = []
    predict_cli.main(["-i", str(a3m), "-o", str(out), "-mdir", str(mdir),
                      "-nrows", "16", "-nrec", "1", "--no-bf16",
                      "--device", "cpu"], timings=timings)
    assert "done!" in capsys.readouterr().out
    assert [t for t, _ in timings] == [
        "msa_filter", "weights", "esm", "features", "trunk_0",
        "structure_0", "trunk_1", "structure_1", "write"]
    # the filter artifact, byte-identical to the JAX package's
    filt = out / "filter16.a3m"
    ref_filt = root / "jax_filter16.a3m"
    parsed = jparse_a3m(str(a3m), limit=30000)
    jfilter.write_filtered_a3m(str(a3m), str(ref_filt),
                               jfilter.hhfilter_diff_indices(parsed, 16,
                                                             exact=True))
    assert filt.read_bytes() == ref_filt.read_bytes()
    ref = _jax_predict(filt, esm, fold, 16, 1, monkeypatch)
    with np.load(out / "model_1_results.npz") as f:
        assert set(f.files) == {"plddt", *KEYS}
        for key, n in KEYS.items():
            assert f[key].shape == (L, L, n) and f[key].dtype == np.float32
            assert np.abs(f[key].sum(-1) - 1).max() < 1e-5
            assert np.abs(f[key] - ref[key]).max() < F32_TOL, key
        plddt = f["plddt"]
    assert plddt.shape == (L,) and ((plddt >= 0) & (plddt <= 1)).all()
    assert np.abs(plddt - ref["plddt"]).max() < F32_TOL
    lines = (out / "plddt.csv").read_text().splitlines()
    assert lines[0] == "Residue_Index,pLDDT" and len(lines) == L + 1
    assert lines[1] == f"1,{float(plddt[0])}"
    atoms = [ln for ln in (out / "model_1.pdb").read_text().splitlines()
             if ln.startswith("ATOM")]
    assert len({ln[22:26] for ln in atoms}) == L
    ca = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])]
                   for ln in atoms if ln[12:16].strip() == "CA"])
    assert np.abs(ca - ref["atom14"][:, 1]).max() < COORD_TOL + 1e-3
    assert abs(float(atoms[0][60:66]) - 100 * plddt[0]) < 0.01


def test_cli_predict_bf16_default_and_reuse(cli_case):
    """At the CLI's default (bf16) the same files; an existing
    filter{n}.a3m is reused, not rewritten."""
    root, mdir, a3m, _, _ = cli_case
    out = root / "bf16"
    out.mkdir()
    filt = out / "filter16.a3m"
    kept = tfilter.hhfilter_diff_indices(
        jparse_a3m(str(a3m), limit=30000), 16, exact=True)[:17]
    tfilter.write_filtered_a3m(str(a3m), str(filt), kept)
    before = filt.read_bytes()
    res = predict_cli.main(["-i", str(a3m), "-o", str(out), "-mdir",
                            str(mdir), "-nrows", "16", "-nrec", "1",
                            "--device", "cpu"])
    assert filt.read_bytes() == before
    assert res["atom14"].dtype == torch.float32
    with np.load(out / "model_1_results.npz") as f:
        for key in KEYS:
            assert np.isfinite(f[key]).all()
            assert np.abs(f[key].sum(-1) - 1).max() < 1e-5
    assert (out / "model_1.pdb").exists() and (out / "plddt.csv").exists()


def test_cli_predict_refuses_zero_embeddings(cli_case, tmp_path):
    _, _, a3m, esm, fold = cli_case
    dead = dict(esm)
    for k in ("emb_layer_norm_after.weight", "emb_layer_norm_after.bias"):
        dead[k] = np.zeros_like(esm[k])
    convert.save_params_npz(dead, str(tmp_path /
                                      "esm_msa1_t12_100M_UR50S.npz"))
    convert.save_params_npz(fold, str(tmp_path / "model_1.npz"))
    with pytest.raises(ValueError, match="fails to generate embeddings"):
        predict_cli.main(["-i", str(a3m), "-o", str(tmp_path / "o"),
                          "-mdir", str(tmp_path), "-nrows", "16",
                          "--no-bf16", "--device", "cpu"])


def test_find_extension_order(tmp_path):
    for ext in (".npz", ".pth"):
        (tmp_path / f"model_1{ext}").write_text("")
    assert predict_cli._find(str(tmp_path), "model_1",
                             (".pth.tar", ".pth", ".npz")).endswith(".pth")
    (tmp_path / "model_1.pth.tar").write_text("")
    assert predict_cli._find(str(tmp_path), "model_1",
                             (".pth.tar", ".pth", ".npz")).endswith(".tar")
    with pytest.raises(FileNotFoundError):
        predict_cli._find(str(tmp_path), "esm", (".pt", ".npz"))

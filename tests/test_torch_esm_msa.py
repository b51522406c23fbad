"""The port's ESM-MSA-1b against the JAX package's, on the CPU.

Both run the same seeded random weights at 2 layers x 32 wide x 4 heads
(the JAX module's dimension constants patched narrow, its eager
esm_msa_apply, as its own tests do) on one seeded MSA of 6 rows x 13
columns. Representations, row attentions, logits and the contact head
agree within 1e-4 absolute (float32 both; entries O(1), layer norms with
eps 1e-12 amplify rounding where a row's variance is small).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import trx2dy.models.esm_msa as jesm
from trx2dy_torch.models import esm_msa as tesm
from trx2dy_torch.models.convert import build_esm, init_esm_state_dict

torch.set_num_threads(2)

LAYERS, DIM, HEADS, FFN = 2, 32, 4, 64
TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    return init_esm_state_dict(3, layers=LAYERS, embed_dim=DIM, heads=HEADS,
                               ffn_dim=FFN)


@pytest.fixture
def narrow_jax(monkeypatch):
    for name, value in (("EMBED_DIM", DIM), ("HEADS", HEADS),
                        ("HEAD_DIM", DIM // HEADS), ("LAYERS", LAYERS)):
        monkeypatch.setattr(jesm, name, value)


def _tokens(padded: bool):
    rng = np.random.default_rng(5)
    toks = tesm.mymsa_to_esmmsa(rng.integers(0, 21, (6, 12)))
    if padded:
        toks[3:, 9:] = tesm.PADDING_IDX        # ragged rows, row 0 intact
        toks[0, 12] = tesm.PADDING_IDX         # a padded column keyed on row 0
    return toks


CASES = {
    "plain": ({}, False),
    "padded": ({}, True),
    "chunked": ({"row_chunk": 4, "col_chunk": 5}, False),
    "auto_chunked": ({"max_tokens_per_msa": 40}, True),
    "res_idx": ({"res_idx": np.concatenate([np.arange(5),
                                            np.arange(20, 27)])}, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_esm_msa_matches_jax(case, weights, narrow_jax):
    kw, padded = CASES[case]
    toks = _tokens(padded)
    jkw = dict(kw)
    if "res_idx" in jkw:
        jkw["res_idx"] = jnp.asarray(jkw["res_idx"])
    ref = jesm.esm_msa_apply({k: jnp.asarray(v) for k, v in weights.items()},
                             jnp.asarray(toks), repr_layers=(0, 1, LAYERS),
                             **jkw)
    ref_contacts = jesm.contact_head_apply(
        {k: jnp.asarray(v) for k, v in weights.items()},
        ref["row_attentions"])
    model = build_esm({k: torch.from_numpy(v) for k, v in weights.items()},
                      "cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(toks), repr_layers=(0, 1, LAYERS), **kw)
        contacts = model.contacts(out["row_attentions"])
    for layer in (0, 1, LAYERS):
        got = out["representations"][layer].numpy()
        want = np.asarray(ref["representations"][layer])
        assert got.shape == (6, 13, DIM)
        assert np.abs(got - want).max() < TOL, layer
    assert out["row_attentions"].shape == (LAYERS, HEADS, 13, 13)
    assert np.abs(out["row_attentions"].numpy()
                  - np.asarray(ref["row_attentions"])).max() < TOL
    assert np.abs(out["logits"].numpy()
                  - np.asarray(ref["logits"])).max() < TOL
    assert np.abs(contacts.numpy() - np.asarray(ref_contacts)).max() < TOL


def test_chunking_is_exact_in_the_port(weights):
    """Row and column chunking change only the summation order."""
    model = build_esm({k: torch.from_numpy(v) for k, v in weights.items()},
                      "cpu")
    toks = torch.from_numpy(_tokens(True))
    with torch.no_grad():
        a = model(toks, repr_layers=(LAYERS,))
        b = model(toks, repr_layers=(LAYERS,), row_chunk=2, col_chunk=3)
    assert torch.allclose(a["representations"][LAYERS],
                          b["representations"][LAYERS], atol=1e-5)
    assert torch.allclose(a["row_attentions"], b["row_attentions"],
                          atol=1e-6)


def test_token_table_matches_jax():
    rng = np.random.default_rng(0)
    msa = rng.integers(0, 21, (3, 7))
    for kind in ("msa", "fasta"):
        assert np.array_equal(tesm.mymsa_to_esmmsa(msa, kind),
                              np.asarray(jesm.mymsa_to_esmmsa(msa, kind)))

"""The port's features, Predictor2D and geometry stage against the JAX
package, on the CPU (the port's entry points run with device="cpu")."""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from trx2dy.models import predictor2d as jp2d
from trx2dy.models.features import get_f2d as jax_get_f2d
from trx2dy.models.predictor2d_infer import \
    pred_2d_geometry as jax_pred_2d_geometry
from trx2dy_torch.dynamics.driver import WEIGHT_FILES, geometry_stage
from trx2dy_torch.io.a3m import ALPHABET
from trx2dy_torch.models.convert import (
    build_model, init_state_dict, load_into, load_params, param_shapes,
    state_dict_from_flat,
)
from trx2dy_torch.models.features import get_f2d
from trx2dy_torch.models.predictor2d import DistPredictor, TrunkBlock
from trx2dy_torch.models.predictor2d_infer import pred_2d_geometry

torch.set_num_threads(2)

KEYS = {"dist": 37, "omega": 25, "theta": 25, "phi": 13}


def _rand_msa(R, L, seed):
    rng = np.random.default_rng(seed)
    msa = rng.integers(0, 21, (R, L))
    msa[0] = rng.integers(0, 20, L)
    # related rows, so the identity weights of reweight are not all 1
    n = max(R // 2 - 1, 0)
    msa[1:1 + n] = np.where(rng.random((n, L)) < 0.15,
                            rng.integers(0, 21, (n, L)), msa[0])
    return msa


def _write_a3m(path, msa):
    with open(path, "w") as f:
        for n, row in enumerate(msa):
            f.write(f">s{n}\n{''.join(ALPHABET[t] for t in row)}\n")


# --------------------------------------------------------------------------
# features
# --------------------------------------------------------------------------

@pytest.mark.parametrize("R", [12, 1])
def test_get_f2d_matches_jax(R):
    msa = _rand_msa(R, 15, seed=R)
    ref = np.asarray(jax_get_f2d(jnp.asarray(msa)))
    port = get_f2d(torch.from_numpy(msa)).numpy()
    assert port.shape == (15, 15, 526)
    # f32 Cholesky inverse of a 315x315 matrix in two libraries; entries O(1)
    assert np.abs(port - ref).max() < 1e-4
    if R == 1:
        assert np.abs(port[:, :, 84:]).max() == 0.0


# --------------------------------------------------------------------------
# parameters and loading
# --------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 12])
def test_param_names_and_shapes_match_init_params(depth):
    shapes = jax.eval_shape(
        lambda: jp2d.init_params(jax.random.PRNGKey(0), depth=depth))
    assert param_shapes(depth) == {k: tuple(v.shape)
                                   for k, v in shapes.items()}


def test_init_state_dict_noises_biases_and_norms():
    p = init_state_dict(seed=0, depth=1)
    assert p.keys() == param_shapes(1).keys()
    assert np.abs(p["net.conv1.bias"]).min() > 0
    assert np.abs(p["net.net.blocks.0.1.norm.weight"] - 1).max() > 0.05


def test_missing_key_raises_extra_key_listed(tmp_path):
    state = state_dict_from_flat(init_state_dict(seed=1, depth=1))
    model = DistPredictor(depth=1)
    incomplete = dict(state)
    del incomplete["net.net.blocks.0.4.linear1.bias"]
    with pytest.raises(KeyError, match="linear1.bias"):
        load_into(model, incomplete)
    extra = dict(state)
    extra["net.net.blocks.0.2.norm.weight"] = torch.ones(128)  # unused
    path = str(tmp_path / "ckpt.pth")
    torch.save(extra, path)
    assert load_into(model, state_dict_from_flat(load_params(path))) == \
        ["net.net.blocks.0.2.norm.weight"]
    build_model(load_params(path), "cpu")


# --------------------------------------------------------------------------
# one trunk block
# --------------------------------------------------------------------------

def test_trunk_block_matches_jax():
    params = init_state_dict(seed=2, depth=1)
    prefix = "net.net.blocks.0."
    block = TrunkBlock()
    block.load_state_dict({k[len(prefix):]: v for k, v in
                           state_dict_from_flat(params).items()
                           if k.startswith(prefix)})
    rng = np.random.default_rng(4)
    L, R = 12, 6
    x = rng.standard_normal((L, L, 128)).astype(np.float32)
    m = rng.standard_normal((R, L, 128)).astype(np.float32)

    p = {k: jnp.asarray(v) for k, v in params.items()}
    blk = "net.net.blocks.0"
    with jax.disable_jit():
        jm = jnp.asarray(m) + jp2d.msa_attention(p, f"{blk}.1", m, x)
        jm = jm + jp2d.feed_forward(p, f"{blk}.3.fn",
                                    jp2d.layer_norm(p, f"{blk}.3.norm", jm))
        jx = jp2d.update_x(p, f"{blk}.2", x, jm)
        jx = jp2d.tri_update(p, f"{blk}.0", jx)
        jm = jp2d.update_m(p, f"{blk}.4", jx, jm)
    with torch.no_grad():
        tx, tm = block(torch.from_numpy(x), torch.from_numpy(m))
    # f32, same arithmetic in another order; activations are O(10)
    assert np.abs(tx.numpy() - np.asarray(jx)).max() < 1e-3
    assert np.abs(tm.numpy() - np.asarray(jm)).max() < 1e-3


# --------------------------------------------------------------------------
# the whole slice, depth 12
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slice_inputs(tmp_path_factory):
    """Depth-12 noised params as .npz and .pth, and an a3m at L=20, R=12."""
    d = tmp_path_factory.mktemp("slice")
    params = init_state_dict(seed=3, depth=12)
    npz, pth, a3m = str(d / "w.npz"), str(d / "w.pth"), str(d / "t.a3m")
    np.savez(npz, **params)
    torch.save(state_dict_from_flat(params), pth)
    _write_a3m(a3m, _rand_msa(12, 20, seed=5))
    with jax.disable_jit():
        ref = jax_pred_2d_geometry(npz, a3m)
    return npz, pth, a3m, ref


@pytest.mark.parametrize("weights", ["npz", "pth"])
def test_pred_2d_geometry_matches_jax(slice_inputs, weights):
    npz, pth, a3m, ref = slice_inputs
    port = pred_2d_geometry(npz if weights == "npz" else pth, a3m,
                            device="cpu")
    assert port.keys() == ref.keys() == KEYS.keys()
    for key, bins in KEYS.items():
        assert port[key].shape == (20, 20, bins)
        # probabilities after 12 f32 blocks computed in another order
        assert np.abs(port[key] - np.asarray(ref[key])).max() < 1e-4, key


# --------------------------------------------------------------------------
# the geometry stage's file contract
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    for seed, fname in enumerate(WEIGHT_FILES.values()):
        torch.save(state_dict_from_flat(init_state_dict(seed, depth=1)),
                   str(d / fname))
    return str(d)


def test_geometry_stage_layout_and_keys(tmp_path, model_dir):
    a3m = str(tmp_path / "t.a3m")
    _write_a3m(a3m, _rand_msa(8, 11, seed=6))
    paths = geometry_stage("tgt", a3m, str(tmp_path / "out"),
                           model_dir=model_dir, device="cpu")
    npz_dir = tmp_path / "out" / "tgt" / "pred_npz"
    assert paths == {"NMR": str(npz_dir / "tgt_NMR.npz"),
                     "Xray": str(npz_dir / "tgt_Xray.npz")}
    for path in paths.values():
        with np.load(path) as f:
            assert set(f.files) == set(KEYS)
            for key, bins in KEYS.items():
                assert f[key].shape == (11, 11, bins)
                np.testing.assert_allclose(f[key].sum(-1), 1.0, atol=1e-5)


def test_geometry_stage_reuses_and_copies(tmp_path):
    out = tmp_path / "out"
    (out / "tgt" / "pred_npz").mkdir(parents=True)
    np.savez(out / "tgt" / "pred_npz" / "tgt_NMR.npz", marker=np.array(1))
    src = tmp_path / "given"
    src.mkdir()
    np.savez(src / "tgt_Xray.npz", marker=np.array(2))
    paths = geometry_stage("tgt", None, str(out), npz_dir=str(src),
                           device="cpu")
    with np.load(paths["NMR"]) as f:
        assert int(f["marker"]) == 1              # reused as it was
    with np.load(paths["Xray"]) as f:
        assert int(f["marker"]) == 2              # copied from npz_dir
    assert os.path.exists(src / "tgt_Xray.npz")


def test_geometry_stage_without_npz_or_models_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no model_dir"):
        geometry_stage("tgt", None, str(tmp_path), device="cpu")

"""The port's (dp, mp) mesh, its sharded train step, the mp-split trunk
and the decoy-sharded fold, on the CPU.

One 4-process gloo world (dp=2, mp=2; scripts/ranks.py spawn_ranks, the
ranks running tests/torch_parallel_ranks.py, which imports no JAX) runs
every sharded case once per module, from the module's start, beside one
more process computing the port's one-process results on the same
inputs, while the parent computes the JAX package's: the step against
make_train_step(mesh=None) (depth 1, B=2, R=4, L=8), the trunk against
predictor2d_apply (JAX's test shapes: depth 2, R=8, L=12). The fold is
held to one process on the same starts (L=16, 4 decoys, max_iter 5, no
FastRelax).
"""
import concurrent.futures

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

import torch_parallel_ranks as ranks
from trx2dy.models import train as jtrain
from trx2dy.models.predictor2d import predictor2d_apply
from trx2dy_torch.models.convert import init_state_dict
from trx2dy_torch.models.train import HEAD_BINS
from scripts.ranks import spawn_ranks
from trx2dy_torch.parallel.mesh import make_mesh, mesh_shape

torch.set_num_threads(2)

B, R, L = 2, 4, 8
TRUNK_R, TRUNK_L = 8, 12
FOLD_L, FOLD_SEED = 16, 3
SEQ16 = "ARNDCQEGHILKMFPS"
ZERO_GRAD = 1e-6


def _rand_npz(L_, key=0):
    """tests/test_physics.py:_rand_npz."""
    rng = np.random.default_rng(key)

    def soft(shape):
        x = rng.random(shape).astype(np.float32)
        return x / x.sum(-1, keepdims=True)
    return {"dist": soft((L_, L_, 37)), "omega": soft((L_, L_, 25)),
            "theta": soft((L_, L_, 25)), "phi": soft((L_, L_, 13))}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    params = init_state_dict(seed=8, depth=ranks.TRAIN_DEPTH)
    batch = (rng.standard_normal((B, L, L, 526)).astype(np.float32),
             rng.integers(0, 21, (B, R, L)).astype(np.int64),
             {k: rng.integers(0, n, (B, L, L)).astype(np.int64)
              for k, n in HEAD_BINS.items()},
             rng.random((B, L, L)) < 0.8)
    trunk = (init_state_dict(seed=9, depth=ranks.TRUNK_DEPTH),
             rng.standard_normal((TRUNK_L, TRUNK_L, 526)).astype(np.float32),
             rng.integers(0, 21, (TRUNK_R, TRUNK_L)).astype(np.int64))
    fold = (_rand_npz(FOLD_L, key=5), SEQ16, FOLD_SEED)
    return (params, batch), trunk, fold


@pytest.fixture(scope="module", autouse=True)
def world_started(inputs):
    """The world and the one-process references run from the module's
    start, each in processes of their own (one torch thread each, the same
    CPU kernels); teardown waits for both."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = (pool.submit(spawn_ranks, ranks.world, 4, *inputs,
                               timeout=300.0),
                   pool.submit(spawn_ranks, ranks.references, 1, *inputs,
                               timeout=300.0))
        yield futures
        for future in futures:
            future.exception()


@pytest.fixture(scope="module")
def refs(inputs, world_started):
    """The references: the port's one-process results (computed beside
    the world), JAX's unsharded step loss and trunk logits (computed here
    meanwhile)."""
    (params, batch), trunk, fold = inputs
    f2d, msa, labels, mask = batch
    opt = jtrain.make_optimizer(lr=1e-3)
    state = jtrain.init_train_state(
        {k: jnp.asarray(v) for k, v in params.items()}, opt)
    step = jtrain.make_train_step(opt, mesh=None, depth=ranks.TRAIN_DEPTH)
    _, jax_loss = step(state, jnp.asarray(f2d), jnp.asarray(msa),
                       {k: jnp.asarray(v) for k, v in labels.items()},
                       jnp.asarray(mask))
    tparams, tf2d, tmsa = trunk
    jax_trunk = jax.jit(predictor2d_apply, static_argnames="depth")(
        {k: jnp.asarray(v) for k, v in tparams.items()}, jnp.asarray(tf2d),
        jnp.asarray(tmsa), depth=ranks.TRUNK_DEPTH)
    (port,) = world_started[1].result()
    return {**port, "jax_loss": float(jax_loss),
            "jax_trunk": {k: np.asarray(v) for k, v in jax_trunk.items()}}


@pytest.fixture(scope="module")
def world(world_started):
    """Every rank's results (torch_parallel_ranks.world), in rank order."""
    return world_started[0].result()


def _rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("n, shape", [(8, (4, 2)), (4, (2, 2)), (3, (3, 1)),
                                      (1, (1, 1))])
def test_mesh_shape_rule(n, shape):
    """JAX's TestMesh: mp is 2 for an even count above 1, else 1."""
    assert mesh_shape(n) == shape
    with pytest.raises(ValueError, match="not divisible"):
        mesh_shape(n * 2 + 1, mp_size=2)


def test_one_process_mesh_is_1x1():
    created = not dist.is_initialized()
    try:
        mesh = make_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("dp", "mp")
        assert tuple(mesh.shape) == (1, 1)
    finally:
        if created:
            dist.destroy_process_group()


def test_world_mesh_layout(refs, world):
    """rank = dp index * mp + mp index, as JAX reshapes its devices;
    shard_msa gives a rank its dp block of samples and mp block of rows."""
    msa = np.arange(4 * 6 * 3).reshape(4, 6, 3)
    for rank, out in enumerate(world):
        dp, mp = rank // 2, rank % 2
        assert out["shape"] == {"dp": 2, "mp": 2}
        assert out["coords"] == (dp, mp)
        assert np.array_equal(out["msa_shard"],
                              msa[2 * dp:2 * dp + 2, 3 * mp:3 * mp + 3])


@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "dropout"])
def test_sharded_step_matches_one_process(refs, world, dropout):
    """Loss within 1e-5 and every gradient within 1e-5 relative to its
    largest magnitude; a gradient that is zero in exact arithmetic (the
    unread attn_width.pair_*, the last block's UpdateM, biases feeding an
    instance norm) is rounding: at most ZERO_GRAD of the largest."""
    loss, grads = world[0]["grads"][dropout]
    ref_loss, ref = refs["grads"][dropout]
    assert all(out["grads"][dropout][0] == loss for out in world)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    top = max(float(np.abs(r).max()) for r in ref.values())
    for k, r in ref.items():
        scale = float(np.abs(r).max())
        if scale <= ZERO_GRAD * top:
            assert float(np.abs(grads[k]).max()) <= ZERO_GRAD * top, k
        else:
            assert _rel(grads[k], r) < 1e-5, k


def test_sharded_step_matches_jax_unsharded_step(refs, world):
    assert abs(world[0]["grads"][False][0] - refs["jax_loss"]) \
        <= 1e-4 * abs(refs["jax_loss"])


def test_sharded_steps_keep_ranks_bitwise_equal(world):
    """3 steps with dropout and remat: every rank reports the same losses
    and holds bit-identical parameters."""
    losses, digest = world[0]["steps"]
    assert all(np.isfinite(losses))
    for out in world[1:]:
        assert out["steps"] == (losses, digest)


def test_mp_trunk_matches_unsharded_and_jax(refs, world):
    """JAX's own bound (atol 2e-4, rtol 1e-4); against one process within
    1e-5 of the largest logit (the sums over rows run in two halves)."""
    for k, v in world[0]["trunk"].items():
        np.testing.assert_allclose(v, refs["jax_trunk"][k], atol=2e-4,
                                   rtol=1e-4)
        assert _rel(v, refs["trunk"][k]) <= 1e-5, k


def test_sharded_fold_matches_one_process(refs, world):
    """The starts each rank folded, gathered, are one process's draws; per
    decoy, in global order, within 1e-4 of one process folding all four
    from them; packing gathered alike; every rank holds the same whole
    result."""
    got, ref = world[0]["fold"], refs["fold"]
    assert np.array_equal(got["starts"], ref["starts"])   # the same draws
    for k in ("torsions", "ca", "xyz", "chi"):
        assert got[k].shape == ref[k].shape
        assert np.abs(got[k] - ref[k]).max() <= 1e-4 * max(
            1.0, np.abs(ref[k]).max()), k
    assert np.abs(got["energy"] - ref["energy"]).max() <= \
        1e-4 * np.abs(ref["energy"]).max()
    assert len({out["fold_digest"] for out in world}) == 1


def test_sharded_fold_refuses_indivisible_count(world):
    for out in world:
        assert "n_decoys=3 not divisible by dp=2" in out["indivisible"]

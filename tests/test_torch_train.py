"""The port's training path against the JAX package's, on the CPU.

Depth 1, L=10, R=4, B=2, one set of seeded weights and inputs for every
case. The JAX references are computed once per module and compile four
programs: the float32 loss and gradients without and with dropout (one
program; the dropout masks come out beside the loss, recorded from
jax.random.bernoulli in call order), the heads' loss on given logits in
float64, optax's update in float64, and the CLI's step. The port's train
step runs with remat off and on.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from trx2dy.models import train as jtrain
from trx2dy.models.dataset import labels_from_structure as jax_labels
from trx2dy.models.torch_convert import load_params_npz as jax_load_npz
from trx2dy_torch.io.a3m import ALPHABET
from trx2dy_torch.io.pdbio import write_pdb_backbone
from trx2dy_torch.models import train
from trx2dy_torch.models.convert import (
    build_model, init_state_dict, load_params, param_shapes,
)
from trx2dy_torch.models.dataset import labels_from_structure
from trx2dy_torch.models.predictor2d import (
    FF_DROPOUT, PAIR_DROPOUT, apply_dropout, draw_dropout, dropout_shapes,
)
from trx2dy_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

DEPTH, L, R, B = 1, 10, 4, 2
STEPS = 3
ZERO_GRAD = 1e-6


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    params = init_state_dict(seed=5, depth=DEPTH)
    f2d = rng.standard_normal((B, L, L, 526)).astype(np.float32)
    msa = rng.integers(0, 21, (B, R, L)).astype(np.int64)
    labels = {k: rng.integers(0, n, (B, L, L)).astype(np.int32)
              for k, n in train.HEAD_BINS.items()}
    mask = rng.random((B, L, L)) < 0.8
    return params, f2d, msa, labels, mask


def _sample(data, b=0):
    """One sample's inputs for both packages, as numpy."""
    _, f2d, msa, labels, mask = data
    return f2d[b], msa[b], {k: v[b] for k, v in labels.items()}, mask[b]


@pytest.fixture(scope="module")
def jax_loss(data):
    """JAX's float32 loss and gradients on sample 0, without and with
    dropout (with the masks it drew, in call order)."""
    params = data[0]
    f2d, msa, labels, mask = _sample(data)
    drawn = []
    bernoulli = jax.random.bernoulli

    def recording(key, p=0.5, shape=None):
        out = bernoulli(key, p, shape)
        drawn.append(out)
        return out

    def both(p, rng):
        def plain(p):
            return jtrain.geometry_loss(p, f2d, msa, labels, mask,
                                        depth=DEPTH)

        def dropped(p):
            drawn.clear()
            loss = jtrain.geometry_loss(p, f2d, msa, labels, mask,
                                        depth=DEPTH, dropout_rng=rng)
            return loss, list(drawn)
        return (jax.value_and_grad(plain)(p),
                jax.value_and_grad(dropped, has_aux=True)(p))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", recording)
        (loss, grads), ((dloss, masks), dgrads) = jax.jit(both)(
            {k: jnp.asarray(v) for k, v in params.items()},
            jax.random.PRNGKey(3))
    np_ = lambda g: {k: np.asarray(v) for k, v in g.items()}
    return {"plain": (np.asarray(loss), np_(grads)),
            "dropout": (np.asarray(dloss), np_(dgrads),
                        [np.asarray(m) for m in masks])}


def _port_loss_grads(params, inputs, **kwargs):
    model = build_model(params, "cpu")
    f2d, msa, labels, mask = inputs
    loss = train.geometry_loss(
        model, torch.as_tensor(f2d), torch.as_tensor(msa),
        {k: torch.as_tensor(v) for k, v in labels.items()},
        torch.as_tensor(mask), **kwargs)
    loss.backward()
    return loss.detach().numpy(), {k: p.grad.numpy() if p.grad is not None
                                   else np.zeros(p.shape)
                                   for k, p in model.named_parameters()}


def _assert_close(port, ref, tol):
    """Each gradient within tol of JAX's, relative to JAX's largest
    magnitude in that tensor. A gradient that is zero in exact arithmetic
    (a bias that feeds an instance norm or a softmax's shift, the unread
    attn_width.pair_*, the last block's UpdateM) is rounding in both
    packages: at most ZERO_GRAD of the largest gradient, in both."""
    top = max(float(np.abs(r).max()) for r in ref.values())
    for k, r in ref.items():
        scale = float(np.abs(r).max())
        if scale <= ZERO_GRAD * top:
            assert float(np.abs(port[k]).max()) <= ZERO_GRAD * top, k
            continue
        err = float(np.abs(port[k] - r).max()) / scale
        assert err <= tol, (k, err)


def test_geometry_loss_and_grads_match_jax(data, jax_loss):
    """The whole model in float32, as both packages train."""
    loss, grads = _port_loss_grads(data[0], _sample(data))
    ref_loss, ref_grads = jax_loss["plain"]
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    assert grads.keys() == ref_grads.keys()
    _assert_close(grads, ref_grads, 1e-5)


@pytest.fixture(scope="module")
def jax_head_loss(data):
    """JAX's geometry_loss and its gradient on given float64 logits (its
    predictor2d_apply stubbed to return them), under each mask: the
    sample's, none valid, and all valid (JAX's default for no mask)."""
    _, _, msa, labels, mask = data
    rng = np.random.default_rng(12)
    logits = {k: rng.standard_normal((L, L, n)) * 3.0
              for k, n in train.HEAD_BINS.items()}
    masks = {"partial": mask[0], "empty": np.zeros_like(mask[0]),
             "none": np.ones_like(mask[0])}
    f2d = np.zeros((L, L, 1))
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "predictor2d_apply", lambda p, *a, **k: p)
        fn = jax.jit(jax.value_and_grad(
            lambda lg, m: jtrain.geometry_loss(
                lg, f2d, msa[0], {k: v[0] for k, v in labels.items()}, m)))
        ref = {name: fn({k: jnp.asarray(v) for k, v in logits.items()},
                        jnp.asarray(m)) for name, m in masks.items()}
    ref = {name: (float(loss), {k: np.asarray(g) for k, g in grads.items()})
           for name, (loss, grads) in ref.items()}
    return logits, masks, ref


@pytest.mark.parametrize("case", ["partial", "empty", "none"])
def test_head_loss_matches_jax_f64(data, jax_head_loss, case):
    """The masked mean cross-entropy summed over the heads, with
    max(sum(mask), 1), and its gradient in float64 (the trunk's norms take
    float32 statistics in both packages, so float64 holds the loss of the
    heads)."""
    _, _, msa, labels, _ = data
    logits, masks, ref = jax_head_loss
    lg = {k: torch.tensor(v, requires_grad=True) for k, v in logits.items()}
    loss = train.geometry_loss(
        lambda f2d, msa, **kw: lg, torch.zeros(L, L, 1), torch.as_tensor(
            msa[0]), {k: torch.as_tensor(v[0]) for k, v in labels.items()},
        None if case == "none" else torch.as_tensor(masks[case]))
    loss.backward()
    ref_loss, ref_grads = ref[case]
    assert abs(loss.item() - ref_loss) <= 1e-10 * max(abs(ref_loss), 1e-300)
    for k, g in ref_grads.items():
        assert np.abs(lg[k].grad.numpy() - g).max() <= 1e-10, k
    if case == "empty":
        assert ref_loss == 0.0 and loss.item() == 0.0


def test_dropout_replayed_matches_jax(data, jax_loss):
    ref_loss, ref_grads, masks = jax_loss["dropout"]
    assert [m.shape for m in masks] == list(dropout_shapes(L, R))
    drop = [tuple(torch.tensor(m) for m in masks)]
    loss, grads = _port_loss_grads(data[0], _sample(data), dropout=drop)
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    _assert_close(grads, ref_grads, 1e-5)
    # the masks moved the loss: dropout ran on both sides
    assert abs(float(ref_loss) - float(jax_loss["plain"][0])) > 1e-3


def _batch(data):
    _, f2d, msa, labels, mask = data
    return (torch.as_tensor(f2d), torch.as_tensor(msa),
            {k: torch.as_tensor(v) for k, v in labels.items()},
            torch.as_tensor(mask))


@pytest.fixture(scope="module")
def optax_update():
    """optax's update (JAX's make_optimizer, clip then AdamW) jitted in
    float64: state, grads, params -> new params, new state."""
    opt = jtrain.make_optimizer()

    def update(opt_state, grads, params):
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    with jax.enable_x64(True):
        yield opt, jax.jit(update)


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
def test_train_steps_match_optax(data, optax_update, monkeypatch, remat):
    """Three make_train_step steps in float32. optax, in float64, takes the
    gradients each step computed (before the clip) and carries its own
    parameters and moments; after each step the port's parameters are
    within 1e-5 of optax's. Its gradients are held to JAX's above; this
    holds the clip, AdamW with decay on every parameter, and the step's
    plumbing."""
    opt_ref, update = optax_update
    model = build_model(data[0], "cpu")
    names = [k for k, _ in model.named_parameters()]
    seen = []
    real_update = train.Optimizer.update

    def recording(self, opt_state):
        params = [p for g in opt_state.param_groups for p in g["params"]]
        seen.append({k: np.zeros(p.shape) if p.grad is None
                     else p.grad.double().numpy()
                     for k, p in zip(names, params)})
        return real_update(self, opt_state)

    monkeypatch.setattr(train.Optimizer, "update", recording)
    ref = {k: v.astype(np.float64) for k, v in data[0].items()}
    opt = train.make_optimizer()
    state = train.init_train_state(model, opt)
    step = train.make_train_step(opt, remat=remat)
    batch = _batch(data)
    with jax.enable_x64(True):
        ref_state = opt_ref.init(ref)
        for i in range(STEPS):
            state, loss = step(state, *batch)
            assert np.isfinite(float(loss))
            ref, ref_state = update(ref_state, seen[i], ref)
            port = {k: v.detach().numpy()
                    for k, v in state.model.state_dict().items()}
            for k, r in ref.items():
                assert np.abs(port[k] - np.asarray(r)).max() <= 1e-5, (i, k)
    # the first step's gradient norm is above the clip: clipping ran
    norm = np.sqrt(sum(float((g ** 2).sum()) for g in seen[0].values()))
    assert norm > opt.clip
    # parameters the loss does not read (zero gradient) decayed as in optax
    unread = [k for k in names if not seen[0][k].any()]
    assert unread and all(
        not np.array_equal(port[k], data[0][k]) for k in unread
        if data[0][k].any())
    assert state.step == STEPS


@pytest.mark.parametrize("norm", [0.5, 3.0], ids=["below_clip", "above_clip"])
def test_clip_by_global_norm_semantics(norm):
    """optax's clip: g * clip / |g| where |g| >= clip, g unchanged below;
    torch's clip_grad_norm_ divides by |g| + 1e-6 instead."""
    params = [torch.nn.Parameter(torch.zeros(3, 4, dtype=torch.float64)),
              torch.nn.Parameter(torch.zeros(5, dtype=torch.float64))]
    gen = torch.Generator().manual_seed(1)
    grads = [torch.randn(p.shape, generator=gen, dtype=torch.float64)
             for p in params]
    scale = norm / torch.linalg.vector_norm(torch.cat([g.flatten()
                                                       for g in grads]))
    for p, g in zip(params, grads):
        p.grad = g * scale
    want = [p.grad * min(1.0, 1.0 / norm) for p in params]
    opt = train.Optimizer(lr=0.0, weight_decay=0.0, clip=1.0)
    opt.update(opt.init(params))
    for p, w in zip(params, want):
        assert torch.allclose(p.grad, w, rtol=1e-12, atol=0.0)
        assert torch.equal(p, torch.zeros_like(p))      # lr 0: no move


class _CountOps(TorchDispatchMode):
    """The aten ops dispatched inside the mode, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_update_dispatches_a_fixed_number_of_ops():
    """Optimizer.update dispatches as many ops over 800 parameter tensors as
    over 8 (one of them without a gradient each time), none of which reads
    a value back to the host, and OPTIMIZER_STATS counts every tensor
    covered and the one zero-filled gradient an update."""
    stats = train.OPTIMIZER_STATS
    counted = {}
    for n in (8, 800):
        params = [torch.nn.Parameter(torch.ones(i % 5 + 1, 3))
                  for i in range(n)]
        for p in params[1:]:
            p.grad = torch.full_like(p, 0.5)
        opt = train.make_optimizer()
        state = opt.init(params)
        stats.reset()
        opt.update(state)                   # AdamW builds its moments
        params[0].grad = None
        with _CountOps() as mode:
            opt.update(state)
        counted[n] = mode.ops
        assert (stats.updates, stats.tensors, stats.zero_filled) == \
            (2, 2 * n, 2)
        assert "aten._local_scalar_dense.default" not in mode.ops
        assert all(float(state.state[p]["step"]) == 2 for p in params)
    assert len(counted[8]) == len(counted[800]), counted


def test_update_matches_the_per_tensor_clip_and_foreach_adamw():
    """Three float32 updates, the gradients' norm above the clip and below
    it, agree with a norm and a scale per gradient followed by the foreach
    AdamW, within 1e-6 of each parameter's norm."""
    gen = torch.Generator().manual_seed(2)
    shapes = [(3, 4), (5,), (2, 2, 2), (7, 1)]
    params = [torch.nn.Parameter(torch.randn(s, generator=gen))
              for s in shapes]
    ref = [p.detach().clone().requires_grad_(True) for p in params]
    opt = train.make_optimizer()
    state = opt.init(params)
    ref_opt = torch.optim.AdamW(ref, lr=opt.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=opt.weight_decay,
                                foreach=True)
    for size in (5.0, 0.1, 2.0):
        grads = [size * torch.randn(s, generator=gen) for s in shapes]
        for p, r, g in zip(params, ref, grads):
            p.grad, r.grad = g.clone(), g.clone()
        opt.update(state)
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(r.grad) for r in ref]))
        scale = torch.where(norm < opt.clip, 1.0, opt.clip / norm)
        for r in ref:
            r.grad.mul_(scale)
        ref_opt.step()
        for p, r in zip(params, ref):
            assert (p - r).norm() <= 1e-6 * r.norm()
            assert (p.grad - r.grad).norm() <= 1e-6 * r.grad.norm()


def test_dropout_masks_axes_rate_and_scale():
    gen = torch.Generator().manual_seed(0)
    Lm, Rm, d = 64, 8, 128
    (drop,) = draw_dropout(gen, 1, Lm, Rm, d)
    assert [tuple(m.shape) for m in drop] == \
        [(1, Lm, d)] * 3 + [(Lm, 1, d), (Rm, Lm, 4 * d)]
    for m, rate in zip(drop, (PAIR_DROPOUT,) * 4 + (FF_DROPOUT,)):
        assert m.dtype == torch.bool
        assert abs(1.0 - m.float().mean().item() - rate) < 0.02
    x = torch.rand(Lm, Lm, d) + 1.0
    row = apply_dropout(x, drop[0], PAIR_DROPOUT)
    col = apply_dropout(x, drop[3], PAIR_DROPOUT)
    # a row mask is shared over the first axis, a column mask the second
    assert torch.equal(row == 0, (row[:1] == 0).expand_as(row))
    assert torch.equal(col == 0, (col[:, :1] == 0).expand_as(col))
    kept = row != 0
    assert torch.allclose(row[kept], (x / (1.0 - PAIR_DROPOUT))[kept])
    # another generator state, other masks
    (again,) = draw_dropout(gen, 1, Lm, Rm, d)
    assert not torch.equal(again[4], drop[4])


def test_remat_with_dropout_equals_no_remat(data):
    out = []
    for remat in (False, True):
        opt = train.make_optimizer()
        state = train.init_train_state(build_model(data[0], "cpu"), opt)
        step = train.make_train_step(opt, dropout=True, remat=remat,
                                     dropout_seed=4)
        state, loss = step(state, *_batch(data))
        out.append((float(loss), {k: p.grad.clone() for k, p in
                                  state.model.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert l0 == pytest.approx(l1, rel=1e-6)
    for k in g0:
        assert torch.allclose(g0[k], g1[k], rtol=1e-5, atol=1e-7), k
    # the seed picks the masks: step 0 and step 1 differ
    assert train.step_seed(4, 0) != train.step_seed(4, 1)


def test_train_step_pins_float32(data):
    """Building a train step switches TF32 (matmuls and cuDNN's
    convolutions) and bf16 reduced-precision reductions off, whatever the
    caller set before and on any device, as JAX pins Precision.HIGHEST;
    the flags stay off after a step on the CPU."""
    flags = (torch.backends.cuda.matmul, "allow_tf32"), \
        (torch.backends.cudnn, "allow_tf32"), \
        (torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction")
    saved = [getattr(o, n) for o, n in flags]
    try:
        for o, n in flags:
            setattr(o, n, True)
        opt = train.make_optimizer()
        state = train.init_train_state(build_model(data[0], "cpu"), opt)
        step = train.make_train_step(opt)
        assert not any(getattr(o, n) for o, n in flags)
        state, loss = step(state, *_batch(data))
        assert np.isfinite(float(loss)) and state.step == 1
        assert not any(getattr(o, n) for o, n in flags)
    finally:
        for (o, n), v in zip(flags, saved):
            setattr(o, n, v)


@pytest.mark.parametrize("dropout, remat", [(False, False), (True, False),
                                            (False, True), (True, True)],
                         ids=["plain", "dropout", "remat", "dropout_remat"])
def test_make_train_step_with_mesh_raises(data, dropout, remat):
    """A mesh of more ranks than the process group raises; the (1, 1) mesh
    of one process gives the step without a mesh, bit for bit, with and
    without dropout and remat (the sharded step on four ranks:
    tests/test_torch_parallel.py)."""
    created = not dist.is_initialized()
    try:
        with pytest.raises(ValueError, match="2 ranks"):
            make_mesh(world_size=2, device_type="cpu")
        mesh = make_mesh(device_type="cpu")
        params, f2d, msa, labels, mask = data
        batch = (torch.from_numpy(f2d), torch.from_numpy(msa),
                 {k: torch.from_numpy(v) for k, v in labels.items()},
                 torch.from_numpy(mask))
        out = []
        for m in (None, mesh):
            opt = train.make_optimizer()
            state = train.init_train_state(build_model(params, "cpu"), opt)
            state, loss = train.make_train_step(
                opt, mesh=m, depth=DEPTH, dropout=dropout,
                remat=remat)(state, *batch)
            out.append((float(loss), [p.detach().clone()
                                      for p in state.model.parameters()]))
        assert out[0][0] == out[1][0]
        assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()


def test_row_parameters_are_the_msa_rows_modules(data):
    """The parameters whose gradients the sharded step sums over mp: every
    one of the modules that read MSA rows, and none of the pair path's
    (attn_height's pair_norm and pair_linear bias its rows from the pair;
    attn_width's are read by nothing)."""
    model = build_model(data[0], "cpu")
    rows = {id(p) for p in model.net.row_parameters()}
    names = {k for k, p in model.named_parameters() if id(p) in rows}
    per_block = {"1.norm", "1.fn.attn_width.to_q", "1.fn.attn_width.to_kv",
                 "1.fn.attn_width.to_out", "1.fn.attn_height.to_q",
                 "1.fn.attn_height.to_kv", "1.fn.attn_height.to_out",
                 "2.proj_down1", "3", "4.norm2", "4.linear2", "4.norm3",
                 "4.ff"}
    want = {k for k, _ in model.named_parameters()
            if k.startswith("net.token_emb.")
            or any(k.startswith(f"net.net.blocks.{b}.{m}.")
                   for b in range(DEPTH) for m in per_block)}
    assert names == want
    assert not any(".pair_" in k or f"blocks.{b}.0." in k
                   for k in names for b in range(DEPTH))


def test_reduce_gradients_fills_unread_parameters(data):
    """On the one-process mesh the reduction changes no gradient and gives
    every parameter the loss does not read a zero one, as optax sees it."""
    created = not dist.is_initialized()
    try:
        mesh = make_mesh(device_type="cpu")
        params, f2d, msa, labels, mask = data
        model = build_model(params, "cpu")
        train.batched_loss(model, torch.from_numpy(f2d),
                           torch.from_numpy(msa),
                           {k: torch.from_numpy(v) for k, v in labels.items()},
                           torch.from_numpy(mask), depth=DEPTH).backward()
        before = {k: None if p.grad is None else p.grad.clone()
                  for k, p in model.named_parameters()}
        assert any(g is None for g in before.values())
        train.reduce_gradients(model, mesh)
        for k, p in model.named_parameters():
            if before[k] is None:
                assert not p.grad.any(), k
            else:
                assert torch.equal(p.grad, before[k]), k
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()


# --------------------------------------------------------------------------
# labels and the CLI
# --------------------------------------------------------------------------

def _backbone(Lb, seed):
    """A helical N/CA/C/O/CB backbone with small noise (numpy, float64)."""
    rng = np.random.default_rng(seed)
    t = np.arange(Lb)
    ca = np.stack([2.3 * np.cos(t * 100 * np.pi / 180),
                   2.3 * np.sin(t * 100 * np.pi / 180), 1.5 * t], -1)
    ca = ca + 0.3 * rng.standard_normal(ca.shape)
    off = lambda s: s * rng.standard_normal(ca.shape)
    return {"N": ca + np.array([-1.0, 0.6, -0.5]) + off(0.1),
            "CA": ca,
            "C": ca + np.array([1.0, 0.5, 0.6]) + off(0.1),
            "O": ca + np.array([1.6, 1.2, 1.3]) + off(0.1),
            "CB": ca + np.array([0.2, -1.3, 0.4]) + off(0.1)}


def test_labels_from_structure_bit_equal_to_jax():
    coords = _backbone(24, seed=2)
    for a in ("N", "CA", "C", "O", "CB"):
        coords[a][7] = np.nan            # one missing residue
    coords["CB"][12] = np.nan           # a missing CB: the virtual one
    seq = "ACDEFGHIKLMNPQRSTVWYACDE"
    labels, mask = labels_from_structure(coords, seq)
    ref_labels, ref_mask = jax_labels(coords, seq)
    assert np.array_equal(mask, ref_mask) and not mask[7].any()
    for k in train.HEAD_BINS:
        assert labels[k].dtype == np.int32
        assert np.array_equal(labels[k], ref_labels[k]), k
    assert len(np.unique(labels["dist"])) > 5


def _write_target(root, name, Lt, rows, seed):
    rng = np.random.default_rng(seed)
    msa = rng.integers(0, 20, (rows, Lt))
    with open(os.path.join(root, name + ".a3m"), "w") as f:
        for n, toks in enumerate(msa):
            f.write(f">s{n}\n{''.join(ALPHABET[t] for t in toks)}\n")
    seq = "".join(ALPHABET[t] for t in msa[0])
    write_pdb_backbone(os.path.join(root, name + ".pdb"), seq,
                       _backbone(Lt, seed))
    return msa[0]


def test_cli_matches_jax_order_and_checkpoints(tmp_path, monkeypatch, capsys):
    """Two steps of each CLI on three targets: the same example order, and
    each package reads the other's checkpoint (JAX's run resumes from the
    port's; its step's loss and optimizer are stubbed, which keeps its
    program small)."""
    import trx2dy.cli.train as jcli
    import trx2dy.models.features as jfeatures
    from trx2dy_torch.cli import train as cli
    import trx2dy_torch.models.features as features

    data_dir = tmp_path / "data"
    data_dir.mkdir()
    queries = {name: _write_target(str(data_dir), name, 8, 5, seed)
               for seed, name in enumerate(("t_a", "t_b", "t_c"))}
    (data_dir / "orphan.a3m").write_text(">q\nAAAAAAAA\n")    # no PDB

    def recorder(fn, seen):
        def wrapped(msa):
            seen.append(np.asarray(msa)[0].tolist())
            return fn(msa)
        return wrapped

    port_seen, jax_seen = [], []
    monkeypatch.setattr(features, "get_f2d",
                        recorder(features.get_f2d, port_seen))
    argv = ["--data_dir", str(data_dir), "--steps", "2", "--depth", "1",
            "--msa_rows", "4", "--ckpt_every", "1", "--seed", "6"]
    state, losses = cli.main(argv + ["--out_dir", str(tmp_path / "port"),
                                     "--device", "cpu", "--mesh"])
    out = capsys.readouterr().out
    assert "[trx2dy] 3 training targets" in out
    assert "[trx2dy] mesh {'dp': 1, 'mp': 1}" in out
    assert "[trx2dy] step 0 loss" in out and len(losses) == 2
    assert all(np.isfinite(losses)) and state.step == 2
    ckpt = tmp_path / "port" / "ckpt_2.npz"
    assert (tmp_path / "port" / "ckpt_1.npz").is_file()

    # JAX reads the port's checkpoint and resumes from it
    read = jax_load_npz(str(ckpt))
    assert {k: tuple(v.shape) for k, v in read.items()} == param_shapes(1)
    assert read["net.conv1.weight"].dtype == jnp.float32
    monkeypatch.setattr(jfeatures, "get_f2d", recorder(
        lambda m: jnp.zeros((m.shape[1], m.shape[1], 526)), jax_seen))
    monkeypatch.setattr(jtrain, "geometry_loss",
                        lambda p, f2d, *a, **k: jnp.sum(p["net.conv1.bias"]))
    monkeypatch.setattr(jtrain, "make_optimizer",
                        lambda lr: optax.identity())
    jcli.main(argv + ["--out_dir", str(tmp_path / "jax"),
                      "--resume", str(ckpt)])
    assert port_seen == jax_seen
    assert port_seen[0] in [q.tolist() for q in queries.values()]

    # the port reads JAX's checkpoint, which holds the same keys
    back = load_params(str(tmp_path / "jax" / "ckpt_2.npz"))
    assert {k: v.shape for k, v in back.items()} == param_shapes(1)
    state, _ = cli.main(argv + ["--out_dir", str(tmp_path / "again"),
                                "--device", "cpu", "--resume",
                                str(tmp_path / "jax" / "ckpt_2.npz")])
    assert state.step == 2

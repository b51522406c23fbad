"""Tests of the port that need a CUDA device; each skips without one.

They import neither JAX nor the JAX package (the card's machine has
neither), so they run there without the test suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from trx2dy_torch.ops.triangle_attention import (
    tri_attn_core, tri_attn_core_plain,
)

H, D = 4, 32


def _inputs(L, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen).to(dev)
                 for shape in ((L, L, H, D),) * 3 + ((L, L, H),))


@pytest.mark.gpu
def test_cuda_core_raises_under_grad_and_runs_without():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU takes the plain version")
    q, k, v, b = _inputs(40, seed=9, dev="cuda")
    with torch.no_grad():
        out = tri_attn_core(q, k, v, b, "row")
    ref = tri_attn_core_plain(q.double(), k.double(), v.double(),
                              b.double(), "row")
    assert (out.double() - ref).abs().max().item() < 1e-5
    q.requires_grad_(True)
    before = tri_attn_core.launches
    with pytest.raises(RuntimeError, match="forward-only"):
        tri_attn_core(q, k, v, b, "col")
    assert tri_attn_core.launches == before
    with torch.inference_mode():
        tri_attn_core(q, k, v, b, "col")
    assert tri_attn_core.launches == before + 1


@pytest.mark.gpu
def test_bf16_kernel_holds_float64_and_float32_keeps_its_kernel():
    """bf16 q, k, v and bias take the bf16 kernel, one launch a call,
    within 1e-5 of float64 of the same values: row-wise over AlphaFold2's
    MSA rows at (R, L, H) = (512, 368, 8) and column-wise at a triangle
    shape with a ragged edge. Float32 inputs still take the float32
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU takes the plain version")
    gen = torch.Generator().manual_seed(17)
    for (R, L, heads), wise in (((512, 368, 8), "row"), ((130, 130, 4),
                                                         "col")):
        q, k, v = (torch.randn(R, L, heads, D, generator=gen)
                   .to("cuda", torch.bfloat16) for _ in range(3))
        b = torch.randn(heads, L, L, generator=gen) \
            .to("cuda", torch.bfloat16).permute(1, 2, 0)
        before = (tri_attn_core.launches, tri_attn_core.launches_bf16)
        with torch.no_grad():
            out = tri_attn_core(q, k, v, b, wise)
        assert (tri_attn_core.launches, tri_attn_core.launches_bf16) == \
            (before[0] + 1, before[1] + 1)
        ref = tri_attn_core_plain(q.double(), k.double(), v.double(),
                                  b.double(), wise)
        assert out.dtype == torch.float32
        assert (out.double() - ref).abs().max().item() < 1e-5
        del ref
    before = (tri_attn_core.launches, tri_attn_core.launches_bf16)
    with torch.no_grad():
        tri_attn_core(q.float(), k.float(), v.float(), b.float(), wise)
    assert (tri_attn_core.launches, tri_attn_core.launches_bf16) == \
        (before[0] + 1, before[1])


def _two_rank_step(params, batch):
    """One of two gloo ranks sharing the card, the (1, 2) mesh: the
    sharded step's loss and gradients with dropout (rank 0's), then the
    steps of torch_parallel_ranks.train_steps."""
    import torch_parallel_ranks as ranks
    from trx2dy_torch.device import resolve_device
    from trx2dy_torch.parallel.mesh import make_mesh

    resolve_device("cuda")            # TF32 off, as every entry point
    torch.cuda.set_device(0)
    mesh = make_mesh()
    loss, grads = ranks.loss_and_grads(params, batch, True, mesh, "cuda")
    return loss, grads, ranks.train_steps(params, batch, mesh, "cuda")


@pytest.mark.gpu
def test_two_rank_step_on_the_card_matches_one_process():
    """Two gloo ranks on the one card, the MSA rows split over mp=2: loss
    and per-tensor gradients within 1e-4 of one process on the card
    (relative to each tensor's largest; rounding-only tensors within 1e-6
    of the largest gradient), the ranks' steps bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    import torch_parallel_ranks as ranks
    from trx2dy_torch.device import resolve_device
    from trx2dy_torch.models.convert import init_state_dict
    from trx2dy_torch.models.train import HEAD_BINS
    from scripts.ranks import spawn_ranks

    rng = np.random.default_rng(3)
    B, R, L = 2, 8, 16
    params = init_state_dict(seed=4, depth=ranks.TRAIN_DEPTH)
    batch = (rng.standard_normal((B, L, L, 526)).astype(np.float32),
             rng.integers(0, 21, (B, R, L)).astype(np.int64),
             {k: rng.integers(0, n, (B, L, L)).astype(np.int64)
              for k, n in HEAD_BINS.items()},
             rng.random((B, L, L)) < 0.8)
    resolve_device("cuda")
    out = spawn_ranks(_two_rank_step, 2, params, batch, timeout=300.0)
    ref_loss, ref = ranks.loss_and_grads(params, batch, True, None, "cuda")
    loss, grads, steps = out[0]
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)
    top = max(float(np.abs(r).max()) for r in ref.values())
    for k, r in ref.items():
        scale = float(np.abs(r).max())
        bound = 1e-6 * top if scale <= 1e-6 * top else 1e-4 * scale
        assert float(np.abs(grads[k] - r).max()) <= bound, k
    assert out[1][2] == steps


@pytest.mark.gpu
def test_spans_sync_the_card_once_in_collect_and_nowhere_else(monkeypatch):
    """A Predictor2D forward at L=48 under tracing(True): no
    torch.cuda.synchronize and no Event.synchronize before collect(),
    exactly one in it; each span's device ms comes from its events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trx2dy_torch.device import resolve_device
    from trx2dy_torch.models.convert import build_model, init_state_dict
    from trx2dy_torch.utils import profiling

    dev = resolve_device("cuda")
    model = build_model(init_state_dict(seed=1, depth=2), dev)
    gen = torch.Generator().manual_seed(2)
    L, R = 48, 16
    f2d = torch.randn((L, L, 526), generator=gen).to(dev)
    msa = torch.randint(0, 21, (R, L), generator=gen).to(dev)
    with torch.inference_mode():
        model(f2d, msa)                     # kernels built, CUDA in use
    torch.cuda.synchronize()
    profiling.collect()

    calls = []
    sync, ev_sync = torch.cuda.synchronize, torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (calls.append("device"),
                                         sync(*a, **k))[1])
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda self: (calls.append("event"),
                                      ev_sync(self))[1])
    with profiling.tracing(True), torch.inference_mode():
        model(f2d, msa)
    assert calls == []
    recs = profiling.collect()
    assert calls == ["device"]
    assert [r.name for r in recs] == ["trunk", "heads"]
    for r in recs:
        assert r.device_ms > 0 and r.host_ms > 0


def _per_tensor_clip(grads, clip):
    """The clip before the multi-tensor one: a norm and a scale per
    gradient."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < clip, 1.0, clip / norm)
    for g in grads:
        g.mul_(scale)


def _device_kernels(fn) -> int:
    """The device operations (kernels, copies, sets) fn() issues, by
    torch.profiler."""
    from trx2dy_torch.utils.profiling import device_work
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return len(device_work(prof.events()))


@pytest.mark.gpu
def test_multi_tensor_update_on_the_card(monkeypatch):
    """Three train steps of a depth-2 Predictor2D at L=64: each leaf within
    1e-6 of its norm of the per-tensor clip and foreach AdamW, fed the
    gradients each step computed. One update of the full-width model's
    2007 parameter tensors issues at most 150 device operations (the
    per-tensor clip alone over 4014) and never syncs with the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trx2dy_torch.device import resolve_device
    from trx2dy_torch.models.convert import build_model, init_state_dict
    from trx2dy_torch.models.predictor2d import DistPredictor
    from trx2dy_torch.models.train import (
        HEAD_BINS, Optimizer, init_train_state, make_optimizer,
        make_train_step,
    )

    dev = resolve_device("cuda")
    gen = torch.Generator().manual_seed(6)
    L, R = 64, 16
    f2d = torch.randn((1, L, L, 526), generator=gen).to(dev)
    msa = torch.randint(0, 21, (1, R, L), generator=gen).to(dev)
    labels = {k: torch.randint(0, n, (1, L, L), generator=gen).to(dev)
              for k, n in HEAD_BINS.items()}
    mask = (torch.rand((1, L, L), generator=gen) < 0.8).to(dev)
    opt = make_optimizer()
    state = init_train_state(build_model(init_state_dict(seed=8, depth=2),
                                         dev), opt)
    params = list(state.model.parameters())
    ref = [p.detach().clone().requires_grad_(True) for p in params]
    ref_opt = torch.optim.AdamW(ref, lr=opt.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=opt.weight_decay,
                                foreach=True)
    real_update = Optimizer.update

    def recording(self, opt_state):
        for r, p in zip(ref, params):
            r.grad = torch.zeros_like(r) if p.grad is None \
                else p.grad.detach().clone()
        return real_update(self, opt_state)

    monkeypatch.setattr(Optimizer, "update", recording)
    step = make_train_step(opt, depth=2)
    for _ in range(3):
        state, _ = step(state, f2d, msa, labels, mask)
        _per_tensor_clip([r.grad for r in ref], opt.clip)
        ref_opt.step()
    for (k, p), r in zip(state.model.named_parameters(), ref):
        gap = (p.detach() - r.detach()).norm().item()
        assert gap <= 1e-6 * r.detach().norm().item(), (k, gap)
    monkeypatch.undo()

    full = list(DistPredictor().to(dev).parameters())
    assert len(full) == 2007
    for p in full:
        p.grad = torch.zeros_like(p)
    adamw = opt.init(full)
    opt.update(adamw)                       # AdamW builds its moments

    def update_unsynced():
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.update(adamw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    kernels = _device_kernels(update_unsynced)
    clip_kernels = _device_kernels(
        lambda: _per_tensor_clip([p.grad for p in full], opt.clip))
    assert kernels <= 150 and clip_kernels > 4014, (kernels, clip_kernels)


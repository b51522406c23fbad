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

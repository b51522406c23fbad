"""The port's spans (trx2dy_torch.utils.profiling), on the CPU at small
shapes: off by default, on under torch_trace() or tracing(True), where
they sit and what encloses them, outputs bit-identical either way, and
the device idle split by span on a hand-made event list.

Imports neither JAX nor the JAX package.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from trx2dy_torch.models import convert, train
from trx2dy_torch.models.esm_msa import mymsa_to_esmmsa
from trx2dy_torch.models.features import get_f2d
from trx2dy_torch.models.folding_e2e import E2E_IN_DIM
from trx2dy_torch.models.predictor2d_infer import predict_geometry
from trx2dy_torch.models.structure_module import SMConfig
from trx2dy_torch.utils import profiling
from trx2dy_torch.utils.profiling import (
    OUTSIDE, PREFIX, collect, idle_by_span, span, torch_trace, tracing,
)

torch.set_num_threads(2)

SEQ = "ARNDCQEGHILK"
L, R = len(SEQ), 8
N_RECYCLE = 2
ESM_DIM = 24


@pytest.fixture(autouse=True)
def _no_records():
    """Every test starts and ends with no span left uncollected."""
    collect()
    yield
    collect()


@pytest.fixture(scope="module")
def geometry_models():
    return [convert.build_model(convert.init_state_dict(seed=s, depth=1),
                                "cpu") for s in (1, 2)]


@pytest.fixture(scope="module")
def msa():
    return np.random.default_rng(0).integers(0, 21, (R, L))


@pytest.fixture(scope="module")
def e2e_models():
    esm = convert.build_esm(
        {k: torch.from_numpy(v) for k, v in convert.init_esm_state_dict(
            3, layers=12, embed_dim=ESM_DIM, heads=12, ffn_dim=48).items()},
        "cpu")
    fold = convert.build_folding(
        {k: torch.from_numpy(v) for k, v in convert.init_folding_state_dict(
            4, depth=1, in_dim=E2E_IN_DIM - 2 * (768 - ESM_DIM),
            emb_dim=ESM_DIM, sm=SMConfig(no_heads_ipa=2, c_resnet=32))
         .items()}, "cpu")
    return esm, fold


def _geometry(models, msa):
    return [predict_geometry(m, msa) for m in models]


def _e2e(models, msa):
    esm, fold = models
    toks = torch.as_tensor(mymsa_to_esmmsa(msa))
    with torch.inference_mode():
        emb = esm(toks, repr_layers=(12,), need_head_weights=True)
        out = fold(SEQ, toks, emb["representations"][12],
                   emb["row_attentions"], n_recycle=N_RECYCLE, sm_blocks=2,
                   trunk_depth=1)
    return {k: out[k].numpy() for k in ("atom14", "plddt")}


def _train(msa, steps=1):
    """`steps` train steps as the train CLI's loop takes them (features,
    then the step); the losses and the parameters after."""
    model = convert.build_model(convert.init_state_dict(seed=5, depth=1),
                                "cpu")
    opt = train.make_optimizer()
    state = train.init_train_state(model, opt)
    step_fn = train.make_train_step(opt, depth=1)
    rng = np.random.default_rng(6)
    labels = {k: torch.as_tensor(rng.integers(0, n, (1, L, L)))
              for k, n in train.HEAD_BINS.items()}
    mask = torch.as_tensor(rng.random((1, L, L)) < 0.8)
    tokens = torch.as_tensor(msa)
    losses = []
    for _ in range(steps):
        f2d = get_f2d(tokens)
        state, loss = step_fn(state, f2d[None], tokens[None], labels, mask)
        losses.append(float(loss))
    return losses, {k: p.detach().clone()
                    for k, p in state.model.named_parameters()}


def _tree(records):
    """[(name, parent name or None, root name)] in opening order."""
    return [(r.name, r.parent.name if r.parent else None, r.root.name)
            for r in records]


def _range_names(prof):
    return {e.name for e in prof.events() if e.name.startswith(PREFIX)}


# --------------------------------------------------------------------------
# off
# --------------------------------------------------------------------------

def test_off_by_default_a_span_is_one_shared_object():
    assert span("a") is span("b")
    with span("a") as s:
        assert s is None
    assert collect() == []


@pytest.mark.parametrize("path", ["geometry", "e2e", "train"])
def test_spans_off_record_nothing(path, geometry_models, e2e_models, msa):
    run = {"geometry": lambda: _geometry(geometry_models, msa),
           "e2e": lambda: _e2e(e2e_models, msa),
           "train": lambda: _train(msa)}[path]
    run()
    assert collect() == []
    with tracing(False), torch_trace() as prof:
        run()
    assert collect() == []
    assert _range_names(prof) == set()


# --------------------------------------------------------------------------
# on: where the spans sit
# --------------------------------------------------------------------------

def test_geometry_span_tree(geometry_models, msa):
    with torch_trace() as prof:
        _geometry(geometry_models, msa)
    recs = collect()
    one = [("geometry", None, "geometry"),
           ("features", "geometry", "geometry"),
           ("trunk", "geometry", "geometry"),
           ("heads", "geometry", "geometry"),
           ("output", "geometry", "geometry")]
    assert _tree(recs) == one * 2
    assert sum(r.name == "trunk" for r in recs) == 2
    assert _range_names(prof) == {PREFIX + n for n, _, _ in one}
    assert len({id(r.root) for r in recs}) == 2     # a root per request
    for r in recs:
        assert r.host_ms > 0 and r.device_ms == r.host_ms   # no CUDA here


def test_e2e_span_tree(e2e_models, msa):
    with torch_trace():
        _e2e(e2e_models, msa)
    tree = _tree(collect())
    cycle = [("recycle", "folding", "folding"),
             ("trunk", "folding", "folding"),
             ("heads", "folding", "folding"),
             ("structure", "folding", "folding")]
    assert tree == [("esm", None, "esm"), ("folding", None, "folding"),
                    ("features", "folding", "folding")] \
        + cycle * (1 + N_RECYCLE)


def test_train_span_tree(msa):
    with torch_trace():
        _train(msa, steps=2)
    step = [("features", None, "features"),
            ("train_step", None, "train_step"),
            ("forward", "train_step", "train_step"),
            ("trunk", "forward", "train_step"),
            ("heads", "forward", "train_step"),
            ("backward", "train_step", "train_step"),
            ("optimizer", "train_step", "train_step")]
    assert _tree(collect()) == step * 2


def test_tracing_true_records_without_a_profiler_and_collect_clears(
        geometry_models, msa):
    with tracing(True):
        _geometry(geometry_models[:1], msa)
        with tracing(False):
            _geometry(geometry_models[:1], msa)
    assert [r.name for r in collect()] == ["geometry", "features", "trunk",
                                           "heads", "output"]
    assert collect() == []


def test_collect_keeps_open_spans_for_the_next_call():
    with tracing(True):
        with span("outer"):
            with span("inner"):
                pass
            assert [r.name for r in collect()] == ["inner"]
        (outer,) = collect()
    assert outer.name == "outer" and outer.parent is None \
        and outer.root is outer


# --------------------------------------------------------------------------
# on and off compute the same bits
# --------------------------------------------------------------------------

def test_geometry_bit_identical_on_and_off(geometry_models, msa):
    off = _geometry(geometry_models, msa)
    with torch_trace():
        on = _geometry(geometry_models, msa)
    for a, b in zip(off, on):
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_e2e_bit_identical_on_and_off(e2e_models, msa):
    off = _e2e(e2e_models, msa)
    with torch_trace():
        on = _e2e(e2e_models, msa)
    for k in off:
        assert np.array_equal(off[k], on[k]), k


def test_train_bit_identical_on_and_off(msa):
    loss_off, params_off = _train(msa, steps=2)
    with torch_trace():
        loss_on, params_on = _train(msa, steps=2)
    assert loss_off == loss_on
    for k, p in params_off.items():
        assert torch.equal(p, params_on[k]), k


# --------------------------------------------------------------------------
# idle by span
# --------------------------------------------------------------------------

def _event(name, device, start, end, annotation=False):
    """An events() entry as torch.profiler gives it; `annotation` marks a
    profiler range (user annotation) on either side."""
    return SimpleNamespace(
        name=name, key=name, device_type=device,
        is_user_annotation=annotation, self_device_time_total=end - start,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def test_idle_by_span_on_a_hand_made_trace():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        # host: a request [0, 100] holding a trunk [20, 60], a head [60,
        # 70]; an unrelated host op; a profiler range outside any span
        _event(PREFIX + "geometry", cpu, 0, 100),
        _event(PREFIX + "trunk", cpu, 20, 60),
        _event(PREFIX + "heads", cpu, 60, 70),
        _event("aten::mm", cpu, 25, 30),
        # device: kernels at [10, 15], [30, 50], [52, 55] (overlapping
        # [53, 54]), [90, 95], [130, 140]
        _event("gemm", cuda, 10, 15),
        _event("gemm", cuda, 30, 50),
        _event("copy", cuda, 52, 55),
        _event("copy", cuda, 53, 54),
        _event("norm", cuda, 90, 95),
        _event("norm", cuda, 130, 140),
        # the device-side copy of a host range, over the whole gap
        _event(PREFIX + "heads", cuda, 55, 90),
        _event("Command Buffer Full", cuda, 96, 129),
    ]
    got = idle_by_span(events)
    # gaps: [15, 30] -> geometry 5, trunk 10; [50, 52] -> trunk 2;
    # [55, 90] -> trunk 5, heads 10, geometry 20; [95, 130] -> geometry
    # 5, outside 30
    want = {"trunk": 17e-6, "geometry": 30e-6, "heads": 10e-6,
            OUTSIDE: 30e-6}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k
    assert sum(got.values()) == pytest.approx(87e-6)


def test_idle_by_span_reads_a_profiler_and_a_cpu_trace_is_empty(
        geometry_models, msa):
    with torch_trace() as prof:
        _geometry(geometry_models[:1], msa)
    collect()
    assert idle_by_span(prof) == {}


def test_innermost_prefers_the_later_and_shorter_range():
    pieces = profiling._innermost([(0, 10, "a"), (0, 4, "b"), (4, 4, "c"),
                                   (6, 8, "d")])
    assert pieces == [(0, 4, "b"), (4, 6, "a"), (6, 8, "d"), (8, 10, "a")]


# --------------------------------------------------------------------------
# device work: the spans' device-side copies are not kernels
# --------------------------------------------------------------------------

def _trace_with_span_copies():
    """A trunk span [0, 100] over kernels at [10, 40] and [50, 60], and the
    copies of the span a profiler leaves on the device: one marked a user
    annotation, one carrying only the host range's name."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    return [_event(PREFIX + "trunk", cpu, 0, 100, annotation=True),
            _event("tri_attn_fwd_kernel", cuda, 10, 40),
            _event("gemm", cuda, 50, 60),
            _event(PREFIX + "trunk", cuda, 5, 95, annotation=True),
            _event(PREFIX + "trunk", cuda, 5, 95),
            _event("labelled", cuda, 0, 100, annotation=True),
            _event("Command Buffer Full", cuda, 60, 90)]


def test_device_work_leaves_out_range_copies():
    kept = profiling.device_work(_trace_with_span_copies())
    assert [e.key for e in kept] == ["tri_attn_fwd_kernel", "gemm"]


def test_chip_smoke_device_kernels_ms_leaves_out_span_copies():
    import chip_smoke
    prof = SimpleNamespace(key_averages=_trace_with_span_copies)
    assert chip_smoke.device_kernels_ms(prof) == pytest.approx(40e-3)


def test_port_profile_busy_leaves_out_span_copies(monkeypatch):
    import os
    monkeypatch.syspath_prepend(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scripts"))
    import port_profile
    busy_ms, top = port_profile.kernel_summary(_trace_with_span_copies())
    assert busy_ms == pytest.approx(40e-3)
    assert [(name, n) for name, n, _ in top] == [
        ("tri_attn_fwd_kernel", 1), ("gemm", 1)]


# --------------------------------------------------------------------------
# the switch is per thread; uncollected spans are bounded
# --------------------------------------------------------------------------

def _in_thread(fn):
    import threading
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join()
    return out[0]


def test_tracing_holds_only_in_its_own_thread():
    def open_span():
        with span("other") as s:
            return s

    def off_then_on():
        with tracing(False):
            return open_span()

    with tracing(True):
        assert _in_thread(open_span) is None      # not forced there
        assert _in_thread(off_then_on) is None
        with span("mine") as s:                   # still on here
            assert s is not None
    assert [r.name for r in collect()] == ["mine"]


def test_uncollected_spans_are_dropped_oldest_first(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 8)
    monkeypatch.setattr(profiling._LOG, "dropped", 0)
    with tracing(True), pytest.warns(UserWarning, match="uncollected"):
        for i in range(20):
            with span(f"s{i}"):
                pass
    recs = collect()
    assert len(recs) <= 8
    assert recs[-1].name == "s19"
    assert [r.name for r in recs] == sorted(
        (r.name for r in recs), key=lambda n: int(n[1:]))
    assert profiling._LOG.dropped == 20 - len(recs)

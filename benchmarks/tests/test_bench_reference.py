"""The plain reference against trx2dy_torch's CPU path at tiny sizes, and
the control's lower precisions."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from harness import synthetic
from harness.weights import seeded_state, shapes_of, upcast

CPU = torch.device("cpu")


def _msa(L, rows, seed=0):
    return synthetic.synthetic_msa(L, rows, np.random.default_rng(seed))


def test_features_match_the_port():
    from plainref.features import get_f2d as ref
    from trx2dy_torch.models.features import get_f2d
    tokens = torch.as_tensor(_msa(14, 30).astype(np.int64))
    torch.testing.assert_close(ref(tokens), get_f2d(tokens), rtol=1e-5,
                               atol=1e-5)


def test_predictor2d_matches_the_port():
    from plainref.predictor2d import DistPredictor as Ref
    from trx2dy_torch.models.convert import load_into
    from trx2dy_torch.models.predictor2d import DistPredictor
    from trx2dy_torch.models.predictor2d_infer import predict_geometry
    port = DistPredictor(depth=2).eval()
    state = seeded_state(shapes_of(port), 3, CPU)
    load_into(port, state)
    ref = Ref(depth=2).eval()
    ref.load_state_dict(state)
    msa = _msa(12, 20)
    got = predict_geometry(port, msa)
    from plainref.features import get_f2d
    tokens = torch.as_tensor(msa.astype(np.int64))
    with torch.no_grad():
        want = ref(get_f2d(tokens), tokens)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], torch.softmax(v, -1).numpy(),
                                   atol=1e-5)


def _e2e_models(seed):
    from plainref.esm_msa import ESMMSA as RefESM
    from plainref.folding import Folding as RefFolding
    from plainref.structure_module import SMConfig as RefSM
    from trx2dy_torch.models.convert import build_esm, build_folding
    from trx2dy_torch.models.esm_msa import ESMMSA
    from trx2dy_torch.models.folding_e2e import Folding
    from trx2dy_torch.models.structure_module import SMConfig
    esm_kw = dict(layers=12, embed_dim=24, heads=12, ffn_dim=48)
    fold_kw = dict(depth=1, in_dim=2 * 24 + 144 + 962, emb_dim=24)
    sm = dict(no_heads_ipa=2, c_resnet=32)
    esm_state = seeded_state(shapes_of(ESMMSA(**esm_kw)), seed, CPU,
                             torch.bfloat16)
    fold_state = seeded_state(shapes_of(Folding(**fold_kw,
                                                sm=SMConfig(**sm))),
                              seed + 1, CPU, torch.bfloat16)
    port = (build_esm(upcast(esm_state), CPU),
            build_folding(upcast(fold_state), CPU))
    ref_esm = RefESM(**esm_kw).eval()
    ref_esm.load_state_dict(upcast(esm_state))
    ref_fold = RefFolding(**fold_kw, sm=RefSM(**sm)).eval()
    ref_fold.load_state_dict(upcast(fold_state))
    return port, (ref_esm, ref_fold)


def _e2e(esm, fold, msa, seq):
    from plainref.esm_msa import mymsa_to_esmmsa
    toks = torch.as_tensor(mymsa_to_esmmsa(msa))
    with torch.no_grad():
        emb = esm(toks, repr_layers=(12,), need_head_weights=True)
        reprs, attns = emb["representations"][12], emb["row_attentions"]
        return reprs, attns, fold(seq, toks, reprs, attns, n_recycle=1,
                                  msa_cutoff=20)


def test_e2e_matches_the_port_in_float32():
    """The reference's ESM, Folding and structure module against the
    port's float32 path on the same (bf16-valued) weights."""
    port, ref = _e2e_models(5)
    msa = _msa(11, 16, seed=2)
    seq = synthetic.query_sequence(msa)
    got, want = _e2e(*port, msa, seq), _e2e(*ref, msa, seq)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-5)
    for k in ("atom14", "plddt", "frames"):
        torch.testing.assert_close(got[2][k], want[2][k], rtol=1e-3,
                                   atol=1e-3)
    for k, v in want[2]["geoms"].items():
        torch.testing.assert_close(got[2]["geoms"][k], v, rtol=1e-4,
                                   atol=1e-5)


def test_labels_match_the_port():
    from plainref.train import labels_from_structure as ref
    from trx2dy_torch.models.dataset import labels_from_structure
    bb = synthetic.synthetic_backbone(24, np.random.default_rng(1))
    got, got_mask = labels_from_structure(bb, "A" * 24)
    want, want_mask = ref(bb)
    assert np.array_equal(got_mask, want_mask.numpy())
    for k, v in want.items():
        assert np.array_equal(got[k], v.numpy()), k


def test_train_step_matches_the_port():
    """Three reference steps (loss, clip, AdamW) against the port's train
    step from the same weights on the same examples."""
    from plainref.features import get_f2d as ref_f2d
    from plainref.predictor2d import DistPredictor as Ref
    from plainref.train import AdamW, geometry_loss
    from plainref.train import labels_from_structure as ref_labels
    from trx2dy_torch.models.convert import load_into
    from trx2dy_torch.models.dataset import labels_from_structure
    from trx2dy_torch.models.features import get_f2d
    from trx2dy_torch.models.predictor2d import DistPredictor
    from trx2dy_torch.models.train import (
        init_train_state, make_optimizer, make_train_step,
    )
    port = DistPredictor(depth=1)
    state0 = seeded_state(shapes_of(port), 9, CPU)
    load_into(port, state0)
    opt = make_optimizer()
    ts = init_train_state(port, opt)
    step = make_train_step(opt, depth=1)
    ref = Ref(depth=1)
    ref.load_state_dict(state0)
    ref_opt = AdamW(ref.parameters())
    for n in range(3):
        rng = np.random.default_rng(n)
        msa_np = synthetic.synthetic_msa(12, 10, rng)
        bb = synthetic.synthetic_backbone(12, rng)
        msa = torch.as_tensor(msa_np.astype(np.int64))
        labels, mask = labels_from_structure(bb, "A" * 12)
        ts, loss = step(ts, get_f2d(msa)[None], msa[None],
                        {k: torch.as_tensor(v)[None]
                         for k, v in labels.items()},
                        torch.as_tensor(mask)[None])
        rl, rm = ref_labels(bb)
        ref.zero_grad(set_to_none=True)
        want = geometry_loss(ref, ref_f2d(msa), msa, rl, rm)
        want.backward()
        ref_opt.step()
        # the first loss is computed before any update; later ones move
        # with AdamW's round-off on leaves whose gradient is near zero
        tol = 1e-6 if n == 0 else 1e-4
        assert abs(float(loss) - want.item()) <= tol * abs(want.item())
    change = {k: (p.detach() - state0[k]).norm().item()
              for k, p in port.named_parameters()}
    want = {k: (p.detach() - state0[k]).norm().item()
            for k, p in ref.named_parameters()}
    median = float(np.median(list(want.values())))
    for k, v in want.items():
        assert abs(change[k] - v) <= 1e-2 * max(v, median), k


def test_tf32_rounding():
    from plainref import lowp
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11)])
    with lowp.precision("tf32"):
        got = lowp.rnd(x)
    # ties round away from zero; 10 explicit mantissa bits remain
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                         1.0 + 2 * 2 ** -10, -(1.0 + 2 ** -10)])
    assert torch.equal(got, want)
    assert torch.equal(lowp.rnd(x), x)          # off by default


def test_fp8_rounding_and_gradient():
    from plainref import lowp
    x = torch.linspace(-3.0, 3.0, 101, requires_grad=True)
    with lowp.precision("fp8"):
        y = lowp.rnd(x)
    err = (y - x).abs().max().item()
    assert 0 < err <= 3.0 / 448 * 32       # 3 mantissa bits at the top
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))   # straight through


def test_unknown_precision_is_refused():
    from plainref import lowp
    with pytest.raises(ValueError):
        with lowp.precision("int4"):
            pass

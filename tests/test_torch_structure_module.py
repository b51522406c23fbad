"""The port's quaternion helpers, invariant point attention and structure
module against the JAX package's, on the CPU.

Seeded numpy inputs at L <= 16, a structure module of 2 blocks with 2 IPA
heads (c_s 32, c_z 16, c_ipa 8, c_resnet 32) and random weights with its
checkpoint keys. Tolerances: the rigid algebra within 1e-6; IPA's output
within 1e-5 absolute; frames, angles and the single representation within
1e-4, atom14 coordinates (scaled by trans_scale_factor 10) within 1e-3 Å;
the atom mask exactly. Float32 in both.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from trx2dy.geometry import rigid as jrig
from trx2dy.models import structure_module as jsm
from trx2dy.models.constants import sequence_to_aatype
from trx2dy_torch.geometry import rigid as trig
from trx2dy_torch.models import structure_module as tsm

torch.set_num_threads(2)

CFG = dict(c_s=32, c_z=16, c_ipa=8, c_resnet=32, no_heads_ipa=2,
           no_qk_points=4, no_v_points=8, no_blocks=2)
SEQ = "ARNDCQEGHILKMFPW"
L = len(SEQ)


def _weights(seed=0):
    model = tsm.StructureModule(tsm.SMConfig(**CFG))
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        noise = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        if v.dim() > 1:
            out[k] = noise / np.float32(np.sqrt(v.shape[1]))
        else:
            out[k] = np.float32(0.1) * noise + (0 if k.endswith("bias")
                                                else np.float32(1.0))
    return model, out


def _load(model, w):
    model.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    return model.eval()


def _jparams(w, prefix="sm"):
    return {f"{prefix}.{k}": jnp.asarray(v) for k, v in w.items()}


def _close(port, ref, tol):
    port = port.detach().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= tol, np.abs(port - ref).max()


@pytest.mark.parametrize("fn", ["quat_to_rot", "quat_normalize",
                                "quat_multiply_by_vec", "compose_q_update",
                                "rigid_invert_apply", "identity",
                                "rigid_to_tensor_7"])
def test_quaternion_helpers_match_jax(fn):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(5, 3)).astype(np.float32)
    u = rng.normal(size=(5, 6)).astype(np.float32)
    tq, tv, tu = (torch.from_numpy(a) for a in (q, v, u))
    jq, jv, ju = (jnp.asarray(a) for a in (q, v, u))
    if fn == "quat_to_rot":
        _close(trig.quat_to_rot(tq), jrig.quat_to_rot(jq), 1e-6)
    elif fn == "quat_normalize":
        _close(trig.quat_normalize(3 * tq), jrig.quat_normalize(3 * jq), 1e-6)
    elif fn == "quat_multiply_by_vec":
        _close(trig.quat_multiply_by_vec(tq, tv),
               jrig.quat_multiply_by_vec(jq, jv), 1e-6)
    elif fn == "compose_q_update":
        for a, b in zip(trig.compose_q_update(tq, tv, tu),
                        jrig.compose_q_update(jq, jv, ju)):
            _close(a, b, 1e-6)
    elif fn == "rigid_invert_apply":
        r = trig.Rigid(trig.quat_to_rot(tq), tv)
        jr = jrig.Rigid(jrig.quat_to_rot(jq), jv)
        pts = rng.normal(size=(5, 3)).astype(np.float32)
        _close(trig.rigid_invert_apply(r, torch.from_numpy(pts)),
               jrig.rigid_invert_apply(jr, jnp.asarray(pts)), 1e-5)
        back = trig.rigid_apply(r, trig.rigid_invert_apply(
            r, torch.from_numpy(pts)))
        _close(back, pts, 1e-5)
    elif fn == "identity":
        _close(trig.identity_quats((3,)), jrig.identity_quats((3,)), 0)
        r, jr = trig.identity_rigid((2, 3)), jrig.identity_rigid((2, 3))
        _close(r.rot, jr.rot, 0)
        _close(r.trans, jr.trans, 0)
    else:
        _close(trig.rigid_to_tensor_7(tq, tv), jrig.rigid_to_tensor_7(jq, jv),
               0)


def test_invariant_point_attention_matches_jax():
    model, w = _weights(seed=2)
    model = _load(model, w)
    rng = np.random.default_rng(3)
    s = rng.normal(size=(L, CFG["c_s"])).astype(np.float32)
    z = rng.normal(size=(L, L, CFG["c_z"])).astype(np.float32)
    q = rng.normal(size=(L, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(scale=3.0, size=(L, 3)).astype(np.float32)
    mask = np.ones(L, np.float32)
    mask[-3:] = 0.0
    rig = trig.Rigid(trig.quat_to_rot(torch.from_numpy(q)),
                     torch.from_numpy(t))
    with torch.no_grad():
        out = model.ipa(torch.from_numpy(s), torch.from_numpy(z), rig,
                        torch.from_numpy(mask))
    ref = jsm.invariant_point_attention(
        _jparams(w), "sm.ipa", jnp.asarray(s), jnp.asarray(z),
        jrig.Rigid(jrig.quat_to_rot(jnp.asarray(q)), jnp.asarray(t)),
        jnp.asarray(mask), jsm.SMConfig(**CFG))
    _close(out, ref, 1e-5)


def test_structure_module_matches_jax():
    model, w = _weights(seed=4)
    model = _load(model, w)
    rng = np.random.default_rng(5)
    s = rng.normal(size=(L, CFG["c_s"])).astype(np.float32)
    z = rng.normal(size=(L, L, CFG["c_z"])).astype(np.float32)
    aatype = sequence_to_aatype(SEQ)
    with torch.no_grad():
        out = model(torch.from_numpy(s), torch.from_numpy(z),
                    torch.from_numpy(np.asarray(aatype)))
    ref = jsm.structure_module_apply(
        _jparams(w), "sm", jnp.asarray(s), jnp.asarray(z),
        jnp.asarray(aatype), cfg=jsm.SMConfig(**CFG))
    for key, tol in (("frames", 1e-4), ("angles", 1e-4),
                     ("unnormalized_angles", 1e-4), ("single", 1e-4),
                     ("cords_ca", 1e-3), ("atom14", 1e-3),
                     ("atom14_mask", 0.0)):
        _close(out[key], ref[key], tol)
    assert float(out["atom14"].abs().max()) > 1.0      # not a degenerate pose

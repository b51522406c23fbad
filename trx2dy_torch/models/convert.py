"""Weights for the port's models: load, carry over, convert, make at random.

Port of trx2dy/models/torch_convert.py and predictor2d.cast_params. The
pretrained checkpoints (trX2(NMR)_40.pth, trX2(X-ray)_40.pth, the e2e
model_1.pth.tar) are plain state_dicts, and the JAX package's flat param
dicts use those same keys. So carrying weights over is a cast only: the
keys stay the same and conv weights stay OIHW. The fairseq ESM-MSA-1b
checkpoint (esm_msa1_t12_100M_UR50S.pt) is upgraded first
(upgrade_esm_state_dict).

Loading raises on a missing key and ignores (and lists) an extra one: a
published checkpoint can hold modules that are defined but never run, such
as UpdateX's norm and conv layers, which the JAX package also never reads.

bf16 weights (cast_params) keep their dtype in the module: the e2e
builders assign the tensors (load_state_dict(assign=True)) rather than copy
them into float32 parameters. An npz stores a bf16 array as 2-byte voids
holding its bits, as numpy writes the JAX package's bf16 arrays.
"""
from __future__ import annotations

import argparse
import logging
import re
from typing import Dict, List, Mapping

import numpy as np
import torch

from trx2dy_torch.models.alphafold2 import AF2Config, AlphaFold2
from trx2dy_torch.models.esm_msa import ESMMSA
from trx2dy_torch.models.folding_e2e import Folding
from trx2dy_torch.models.predictor2d import DEPTH, DistPredictor

log = logging.getLogger(__name__)

_BLOCK_RE = re.compile(r"^net\.net\.blocks\.(\d+)\.")


def state_dict_from_flat(params: Mapping[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """The port's state_dict from a flat {checkpoint key: array} dict."""
    return {k: torch.as_tensor(np.asarray(v, dtype=np.float32))
            for k, v in params.items()}


def load_params(path: str) -> Dict[str, np.ndarray]:
    """Flat float32 params from a `.pth` state_dict or a `.npz`."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return {k: np.asarray(f[k], dtype=np.float32) for k in f.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):       # whole-module checkpoint
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in sd.items()}


def depth_of(keys) -> int:
    """Number of trunk blocks named in a checkpoint's keys."""
    idx = [int(m.group(1)) for k in keys if (m := _BLOCK_RE.match(k))]
    if not idx:
        raise KeyError("no net.net.blocks.* keys: not a Predictor2D checkpoint")
    return max(idx) + 1


def load_into(model: torch.nn.Module, state: Mapping[str, torch.Tensor],
              assign: bool = False) -> List[str]:
    """Copy `state` into `model` (with assign, make its tensors the
    model's, dtype and device as given); raise on a missing key, ignore and
    return the extra ones."""
    want = model.state_dict().keys()
    missing = sorted(set(want) - set(state))
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys, e.g. "
                       f"{missing[:5]}")
    extra = sorted(set(state) - set(want))
    if extra:
        log.info("ignoring %d checkpoint keys the model does not read: %s",
                 len(extra), extra)
    model.load_state_dict({k: state[k] for k in want}, strict=True,
                          assign=assign)
    return extra


def build_model(params: Mapping[str, np.ndarray], device) -> DistPredictor:
    """A DistPredictor in eval mode on `device`, depth taken from the keys."""
    state = state_dict_from_flat(params)
    with torch.device("meta"):
        model = DistPredictor(depth=depth_of(state))
    model = model.to_empty(device=device)
    load_into(model, state)
    return model.eval()


def param_shapes(depth: int = DEPTH) -> Dict[str, tuple]:
    """Checkpoint key -> shape of the port's Predictor2D at `depth`."""
    with torch.device("meta"):
        model = DistPredictor(depth=depth)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def init_state_dict(seed: int, depth: int = DEPTH) -> Dict[str, np.ndarray]:
    """Seeded random weights with the checkpoint's keys and shapes.

    Matrices and kernels are normal / sqrt(fan_in). Unlike the JAX
    package's init_params, biases get 0.1-scale noise and 1-D norm weights
    1 + 0.1-scale noise, so a dropped bias or norm affine shows in every
    comparison."""
    return _random_weights(param_shapes(depth), seed)


def _random_weights(shapes: Mapping[str, tuple], seed: int
                    ) -> Dict[str, np.ndarray]:
    """init_state_dict's draw over any {key: shape}."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        noise = rng.standard_normal(shape).astype(np.float32)
        if len(shape) > 1:
            out[name] = noise / np.float32(np.sqrt(np.prod(shape[1:])))
        elif name.endswith(".bias"):
            out[name] = np.float32(0.1) * noise
        else:
            out[name] = np.float32(1.0) + np.float32(0.1) * noise
    return out


# --------------------------------------------------------------------------
# the e2e predictor: ESM-MSA-1b and Folding
# --------------------------------------------------------------------------

def cast_params(state: Mapping[str, torch.Tensor],
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Matrices, kernels and embeddings in `dtype`; norm affines, biases
    and every other 1-D tensor stay float32 (predictor2d.py:59-71, the
    reference's torch.amp.autocast for the trunk)."""
    out = {}
    for k, v in state.items():
        parts = k.split(".")
        is_norm = ((".norm" in k or "bn" in parts[-2])
                   if len(parts) > 1 else False) \
            or k.endswith("layer_norm.weight") or k.endswith("layer_norm.bias")
        out[k] = v.to(dtype) if (not is_norm and v.dtype == torch.float32
                                 and v.dim() > 1) else v
    return out


def _swap_row_column(key: str) -> str:
    if "row" in key:
        return key.replace("row", "column")
    return key.replace("column", "row")


def _strip_encoder(key: str) -> str:
    # 'sentence_encoder.' first, then 'encoder.' (pretrained.py:124)
    if "sentence_encoder." in key:
        key = "".join(key.split("sentence_encoder.")[1:])
    if "encoder." in key:
        key = "".join(key.split("encoder.")[1:])
    return key


def upgrade_esm_state_dict(data) -> Dict[str, torch.Tensor]:
    """The ESM-MSA state_dict from a loaded fairseq checkpoint
    (esm/pretrained.py:119-131, arch msa_transformer): under "model", strip
    the 'sentence_encoder.' / 'encoder.' prefixes and swap 'row' and
    'column' (the checkpoint stores the axial attentions under exchanged
    names). A plain state_dict (already upgraded) passes through."""
    if isinstance(data, dict) and "model" in data:
        return {_strip_encoder(_swap_row_column(k)): v
                for k, v in data["model"].items()}
    return dict(data)


def _as_float(v: torch.Tensor) -> torch.Tensor:
    v = v.detach().cpu()
    return v if v.dtype == torch.bfloat16 else v.float()


def load_state(path: str, esm: bool = False) -> Dict[str, torch.Tensor]:
    """{key: CPU tensor} from a `.npz` (bf16 arrays stay bf16) or a torch
    checkpoint (`.pth`, `.pth.tar`, `.pt`; with esm, the fairseq upgrade);
    floating tensors come out float32 unless stored bf16. A checkpoint is
    unpickled with torch's weights-only loader, which refuses any object
    but tensors and plain containers; fairseq's training `args` (an
    argparse.Namespace) is the one class allowed besides."""
    if path.endswith(".npz"):
        return load_params_npz(path)
    with torch.serialization.safe_globals([argparse.Namespace]):
        data = torch.load(path, map_location="cpu", weights_only=True)
    if esm:
        data = upgrade_esm_state_dict(data)
    return {k: _as_float(v) for k, v in data.items()}


def save_params_npz(params: Mapping, path: str) -> None:
    """Tensors or arrays to a compressed npz; bf16 as its 2-byte bits."""
    arrays = {}
    for k, v in params.items():
        if torch.is_tensor(v):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                arrays[k] = v.view(torch.int16).numpy().view("V2")
                continue
            v = v.numpy()
        arrays[k] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
    """save_params_npz's inverse: 2-byte voids (this module's and the JAX
    package's bf16 arrays) come back bf16, the rest float32."""
    out = {}
    with np.load(path) as f:
        for k in f.files:
            a = f[k]
            if a.dtype.kind == "V" and a.dtype.itemsize == 2:
                out[k] = torch.from_numpy(a.view(np.int16).copy()) \
                    .view(torch.bfloat16)
            else:
                out[k] = torch.from_numpy(np.asarray(a, np.float32))
    return out


_ESM_LAYER_RE = re.compile(r"^layers\.(\d+)\.")


def esm_config_of(state: Mapping[str, torch.Tensor]) -> dict:
    """ESMMSA's constructor arguments from a checkpoint's shapes."""
    layers = 1 + max(int(m.group(1)) for k in state
                     if (m := _ESM_LAYER_RE.match(k)))
    vocab, d = state["embed_tokens.weight"].shape
    return {"layers": layers, "embed_dim": d,
            "heads": state["contact_head.regression.weight"].shape[1]
            // layers,
            "ffn_dim": state["layers.0.feed_forward_layer.layer.fc1.weight"]
            .shape[0],
            "vocab": vocab,
            "max_positions": state["embed_positions.weight"].shape[0] - 2,
            "max_rows": state["msa_position_embedding"].shape[1]}


ALIGN_BYTES = 256


def packed_state(state: Mapping[str, torch.Tensor], device
                 ) -> Dict[str, torch.Tensor]:
    """The tensors on `device` as views into one flat buffer per dtype,
    each starting on a 256-byte boundary: products on unaligned bf16
    weights run ~18 % slower."""
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for k in sorted(state):
        by_dtype.setdefault(state[k].dtype, []).append(k)
    out = {}
    for dtype, keys in by_dtype.items():
        step = ALIGN_BYTES // torch.empty((), dtype=dtype).element_size()
        spans = [-(-state[k].numel() // step) * step for k in keys]
        buf = torch.empty(sum(spans), dtype=dtype, device=device)
        at = 0
        for k, n in zip(keys, spans):
            t = state[k]
            out[k] = buf[at:at + t.numel()].view(t.shape)
            out[k].copy_(t)
            at += n
    return out


def _build(cls, kwargs: dict, state: Mapping[str, torch.Tensor], device,
           dtype) -> torch.nn.Module:
    """cls(**kwargs) on `device` in eval mode, its tensors placed by
    packed_state wherever the state came from; with dtype the weights
    cast by cast_params first."""
    if dtype is not None:
        state = cast_params(state, dtype)
    with torch.device("meta"):
        model = cls(**kwargs)
    load_into(model, packed_state(state, device), assign=True)
    return model.eval()


def build_esm(state: Mapping[str, torch.Tensor], device,
              dtype=None) -> ESMMSA:
    """ESM-MSA on `device` in eval mode, sizes from the keys; with dtype
    (torch.bfloat16) the weights cast by cast_params."""
    return _build(ESMMSA, esm_config_of(state), state, device, dtype)


def build_folding(state: Mapping[str, torch.Tensor], device,
                  dtype=None) -> Folding:
    """The e2e Folding model on `device` in eval mode, sizes from the
    keys; with dtype (torch.bfloat16) the weights cast by cast_params."""
    return _build(Folding, Folding.config_of(state), state, device, dtype)


def _shapes(model: torch.nn.Module) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def init_esm_state_dict(seed: int, **sizes) -> Dict[str, np.ndarray]:
    """Seeded random ESM-MSA weights (init_state_dict's draw) at the
    published sizes unless given (ESMMSA's arguments)."""
    with torch.device("meta"):
        return _random_weights(_shapes(ESMMSA(**sizes)), seed)


def init_folding_state_dict(seed: int, **sizes) -> Dict[str, np.ndarray]:
    """Seeded random Folding weights (init_state_dict's draw) at the
    default sizes unless given (Folding's arguments)."""
    with torch.device("meta"):
        return _random_weights(_shapes(Folding(**sizes)), seed)


# --------------------------------------------------------------------------
# AlphaFold2 (models/alphafold2.py)
# --------------------------------------------------------------------------

_EVO_RE = re.compile(r"^(evoformer|extra_msa)\.(\d+)\.")


def af2_config_of(state: Mapping[str, torch.Tensor]) -> AF2Config:
    """AlphaFold2's widths and depths read from a state's shapes; the bin
    ranges, which no shape holds, are the published ones."""
    def shape(k):
        return tuple(state[k].shape)

    def blocks(stack):
        return 1 + max(int(m.group(2)) for k in state
                       if (m := _EVO_RE.match(k)) and m.group(1) == stack)
    c_m, c_e = shape("embedder.linear_msa_m.weight")[0], \
        shape("embedder.linear_extra.weight")[0]
    heads = shape("evoformer.0.row_attn.to_b.weight")[0]
    extra_heads = shape("extra_msa.0.row_attn.to_b.weight")[0]
    return AF2Config(
        c_m=c_m, c_z=shape("embedder.linear_relpos.weight")[0], c_e=c_e,
        c_s=shape("linear_single.weight")[0],
        evoformer_blocks=blocks("evoformer"), extra_blocks=blocks("extra_msa"),
        msa_heads=heads,
        msa_head_dim=shape("evoformer.0.row_attn.to_gate.weight")[0] // heads,
        extra_heads=extra_heads,
        extra_head_dim=shape("extra_msa.0.row_attn.to_gate.weight")[0]
        // extra_heads,
        outer=shape("evoformer.0.outer_product_mean.linear_a.weight")[0],
        transition=shape("evoformer.0.msa_transition.linear1.weight")[0]
        // c_m,
        max_relative=(shape("embedder.linear_relpos.weight")[1] - 1) // 2,
        recycle_bins=shape("recycling.linear_dist.weight")[1],
        dist_bins=shape("distogram.weight")[0],
        plddt_hidden=shape("plddt.1.weight")[0],
        plddt_bins=shape("plddt.5.weight")[0])


def build_af2(state: Mapping[str, torch.Tensor], device,
              dtype=None) -> AlphaFold2:
    """AlphaFold2 on `device` in eval mode, sizes from the keys; with
    dtype (torch.bfloat16) the weights cast by cast_params."""
    return _build(AlphaFold2, {"cfg": af2_config_of(state)}, state, device,
                  dtype)


def init_af2_state_dict(seed: int, cfg: AF2Config = AF2Config()
                        ) -> Dict[str, torch.Tensor]:
    """Seeded random AlphaFold2 weights (init_state_dict's draw), as CPU
    tensors."""
    with torch.device("meta"):
        shapes = _shapes(AlphaFold2(cfg))
    return {k: torch.from_numpy(v)
            for k, v in _random_weights(shapes, seed).items()}

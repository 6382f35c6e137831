"""JAX param tree -> the port's ``state_dict``.

The port's own copy of the layout rules of ``csts_tpu/convert/to_torch.py``
(the port imports nothing of the JAX package): it takes the channels-last
param tree ``csts_init`` builds and the npz checkpoints hold (leaves as numpy
arrays) and emits tensors under the reference's module names, which are the
port's, so ``CSTS.load_state_dict(sd, strict=True)`` takes it.

* Linear   w (in, out)          -> (out, in)              [transpose]
* Conv3d   w (kT,kH,kW, I/g, O) -> (O, I/g, kT,kH,kW)     [transpose(4,3,0,1,2)]
* ConvT3d  w (kT,kH,kW, O/g, I) -> (I, O/g, kT,kH,kW)     [same transpose]
* scale/bias                    -> LayerNorm weight/bias
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return np.array(x, dtype=np.float32)  # a writable copy, never a view of the tree


def _linear(out: Dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _np(p["w"]).T
    if "b" in p:
        out[f"{prefix}.bias"] = _np(p["b"])


def _conv_w(out: Dict, prefix: str, w) -> None:
    out[f"{prefix}.weight"] = _np(w).transpose(4, 3, 0, 1, 2)


def _conv(out: Dict, prefix: str, p: Mapping) -> None:
    _conv_w(out, prefix, p["w"])
    if "b" in p:
        out[f"{prefix}.bias"] = _np(p["b"])


def _norm(out: Dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _np(p["scale"])
    out[f"{prefix}.bias"] = _np(p["bias"])


def _attention(out: Dict, prefix: str, p: Mapping, upsample: bool) -> None:
    _linear(out, f"{prefix}.qkv", p["qkv"])
    _linear(out, f"{prefix}.proj", p["proj"])
    if "pool_q" in p:
        _conv_w(out, f"{prefix}.{'upsample_q' if upsample else 'pool_q'}", p["pool_q"])
        _norm(out, f"{prefix}.norm_q", p["norm_q"])
    if "pool_k" in p:
        _conv_w(out, f"{prefix}.pool_k", p["pool_k"])
        _norm(out, f"{prefix}.norm_k", p["norm_k"])
        _conv_w(out, f"{prefix}.pool_v", p["pool_v"])
        _norm(out, f"{prefix}.norm_v", p["norm_v"])


def _block(out: Dict, prefix: str, p: Mapping, upsample: bool = False) -> None:
    _norm(out, f"{prefix}.norm1", p["norm1"])
    _attention(out, f"{prefix}.attn", p["attn"], upsample)
    _norm(out, f"{prefix}.norm2", p["norm2"])
    _linear(out, f"{prefix}.mlp.fc1", p["mlp"]["fc1"])
    _linear(out, f"{prefix}.mlp.fc2", p["mlp"]["fc2"])
    if "proj" in p:
        _linear(out, f"{prefix}.proj", p["proj"])


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX CSTS param tree (numpy leaves) -> fp32 ``state_dict`` of
    :class:`csts_torch.models.csts.CSTS`. Components absent from the tree are
    omitted."""
    out: Dict[str, np.ndarray] = {}
    for name in ("patch_embed", "patch_embed_audio"):
        if name in params:
            _conv(out, f"{name}.proj", params[name])
    for name in (
        "pos_embed_spatial", "pos_embed_temporal", "pos_embed_spatial_audio",
        "pos_embed_temporal_audio", "pos_embed", "pos_embed_audio",
    ):
        if name in params:
            out[name] = _np(params[name])
    for i, blk in enumerate(params.get("blocks", [])):
        _block(out, f"blocks.{i}", blk)
    for i, blk in enumerate(params.get("blocks_audio", [])):
        _block(out, f"blocks_audio.{i}", blk)
    for name in ("vision_proj", "audio_proj"):
        if name in params:
            _linear(out, name, params[name])
    for name in ("vision_pool", "audio_pool", "audio_pool2"):
        if name in params:
            _conv(out, name, params[name])
    for name in ("spatial_fusion", "temporal_fusion"):
        if name in params:
            _block(out, name, params[name])
    for i in range(1, 5):
        if f"decode_block{i}" in params:
            _block(out, f"decode_block{i}", params[f"decode_block{i}"], upsample=True)
    if "classifier" in params:
        _conv(out, "classifier", params["classifier"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}

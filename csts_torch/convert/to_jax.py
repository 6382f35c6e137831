"""The port's ``state_dict`` -> the JAX param tree, the inverse of
:mod:`csts_torch.convert.from_jax`.

The tree is the one ``csts_init`` builds and the JAX package's npz
checkpoints hold: nested dicts (and lists of blocks) of channels-last
numpy leaves.

* Linear   (out, in)            -> w (in, out)             [transpose]
* Conv3d   (O, I/g, kT,kH,kW)   -> w (kT,kH,kW, I/g, O)    [transpose(2,3,4,1,0)]
* ConvT3d  (I, O/g, kT,kH,kW)   -> w (kT,kH,kW, O/g, I)    [same transpose; a
                                   decoder block's ``upsample_q`` is stored
                                   as ``pool_q``, as the JAX tree names it]
* LayerNorm weight/bias         -> scale/bias

The JAX package flattens the tree with its dict keys sorted at every level
and its lists in order. :func:`layout` gives, in that order, each leaf's
path, the port's parameter name and the permutation between them, which is
the order of an npz checkpoint's leading leaves (:func:`param_leaf_names`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from csts_torch.models.csts import CSTS, build_spec

LINEAR = (1, 0)
CONV = (2, 3, 4, 1, 0)


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of the JAX tree: the port's parameter ``name``, permuted by
    ``perm`` (None: as it is)."""

    name: str
    perm: Optional[Tuple[int, ...]] = None


def _linear(keys, prefix: str, leaf: Callable) -> dict:
    p = {"w": leaf(f"{prefix}.weight", LINEAR)}
    if f"{prefix}.bias" in keys:
        p["b"] = leaf(f"{prefix}.bias", None)
    return p


def _conv(keys, prefix: str, leaf: Callable) -> dict:
    p = {"w": leaf(f"{prefix}.weight", CONV)}
    if f"{prefix}.bias" in keys:
        p["b"] = leaf(f"{prefix}.bias", None)
    return p


def _norm(prefix: str, leaf: Callable) -> dict:
    return {"scale": leaf(f"{prefix}.weight", None), "bias": leaf(f"{prefix}.bias", None)}


def _attention(keys, prefix: str, upsample: bool, leaf: Callable) -> dict:
    p = {"qkv": _linear(keys, f"{prefix}.qkv", leaf), "proj": _linear(keys, f"{prefix}.proj", leaf)}
    q_name = "upsample_q" if upsample else "pool_q"
    if f"{prefix}.{q_name}.weight" in keys:
        p["pool_q"] = leaf(f"{prefix}.{q_name}.weight", CONV)
        p["norm_q"] = _norm(f"{prefix}.norm_q", leaf)
    if f"{prefix}.pool_k.weight" in keys:
        p["pool_k"] = leaf(f"{prefix}.pool_k.weight", CONV)
        p["norm_k"] = _norm(f"{prefix}.norm_k", leaf)
        p["pool_v"] = leaf(f"{prefix}.pool_v.weight", CONV)
        p["norm_v"] = _norm(f"{prefix}.norm_v", leaf)
    return p


def _block(keys, prefix: str, leaf: Callable, upsample: bool = False) -> dict:
    p = {
        "norm1": _norm(f"{prefix}.norm1", leaf),
        "attn": _attention(keys, f"{prefix}.attn", upsample, leaf),
        "norm2": _norm(f"{prefix}.norm2", leaf),
        "mlp": {"fc1": _linear(keys, f"{prefix}.mlp.fc1", leaf),
                "fc2": _linear(keys, f"{prefix}.mlp.fc2", leaf)},
    }
    if f"{prefix}.proj.weight" in keys:
        p["proj"] = _linear(keys, f"{prefix}.proj", leaf)
    return p


def _count(keys, name: str) -> int:
    pat = re.compile(rf"{name}\.(\d+)\.")
    return 1 + max((int(m.group(1)) for k in keys if (m := pat.match(k))), default=-1)


def _tree(keys, leaf: Callable) -> Dict:
    """The JAX tree over the parameter names ``keys``, each leaf
    ``leaf(name, perm)``. Components absent from ``keys`` are omitted."""
    keys = set(keys)
    p: Dict = {}
    for name in ("patch_embed", "patch_embed_audio"):
        if f"{name}.proj.weight" in keys:
            p[name] = _conv(keys, f"{name}.proj", leaf)
    for name in ("pos_embed_spatial", "pos_embed_temporal", "pos_embed_spatial_audio",
                 "pos_embed_temporal_audio", "pos_embed", "pos_embed_audio"):
        if name in keys:
            p[name] = leaf(name, None)
    for name in ("blocks", "blocks_audio"):
        n = _count(keys, name)
        if n:
            p[name] = [_block(keys, f"{name}.{i}", leaf) for i in range(n)]
    for name in ("vision_proj", "audio_proj"):
        if f"{name}.weight" in keys:
            p[name] = _linear(keys, name, leaf)
    for name in ("vision_pool", "audio_pool", "audio_pool2"):
        if f"{name}.weight" in keys:
            p[name] = _conv(keys, name, leaf)
    for name in ("spatial_fusion", "temporal_fusion"):
        if f"{name}.norm1.weight" in keys:
            p[name] = _block(keys, name, leaf)
    for i in range(1, 5):
        if f"decode_block{i}.norm1.weight" in keys:
            p[f"decode_block{i}"] = _block(keys, f"decode_block{i}", leaf, upsample=True)
    if "classifier.weight" in keys:
        p["classifier"] = _conv(keys, "classifier", leaf)
    return p


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in the JAX package's flatten order: dict keys
    sorted at every level, lists in order; paths joined by ``/`` as
    ``param_leaf_names`` prints them."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out.extend(flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def layout(names) -> List[Tuple[str, Leaf]]:
    """``[(path, Leaf(name, perm)), ...]`` for the parameter ``names``, in
    the JAX package's flatten order."""
    return flatten(_tree(names, Leaf))


def to_jax_leaf(x, perm: Optional[Tuple[int, ...]]) -> np.ndarray:
    """A tensor or array in the JAX tree's layout, as fp32 numpy. A tensor
    is permuted where it lies (on the card, a copy there) and copied to the
    host once."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if perm is not None:
            x = x.permute(*perm)
        return x.to(torch.float32).contiguous().cpu().numpy()
    x = np.asarray(x)
    return x.transpose(perm) if perm is not None else x


def params_from_state_dict(sd: Mapping[str, Any]) -> Dict:
    """The port's ``state_dict`` (or any dict of tensors under its parameter
    names, such as Adam's moments) -> the JAX param tree of float32 numpy
    leaves. Components absent from ``sd`` are omitted."""
    return _tree(sd.keys(), lambda name, perm: to_jax_leaf(sd[name], perm))


def param_leaf_names(cfg) -> List[Tuple[str, Tuple[int, ...]]]:
    """Named model-param leaves ``[(path, shape), ...]`` in the JAX package's
    flatten order: the leading leaves of an npz checkpoint, in order. The
    model is built on the meta device, so no weights are made."""
    with torch.device("meta"):
        model = CSTS(build_spec(cfg))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return [(path, tuple(shapes[leaf.name][i] for i in leaf.perm) if leaf.perm
             else shapes[leaf.name]) for path, leaf in layout(shapes)]

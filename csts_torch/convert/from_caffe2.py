"""Legacy Caffe2 checkpoint reader (``csts_tpu/convert/from_caffe2.py``;
reference ``slowfast/utils/c2_model_loading.py`` and
``slowfast/utils/checkpoint.py:220-288``), numpy only.

The reference accepts ``TRAIN/TEST.CHECKPOINT_TYPE == "caffe2"``: a latin1
pickle with a ``{"blobs": {name: ndarray}}`` payload whose blob names follow
the Caffe2 SlowFast/ResNet convention (``res4_0_branch1_w``, ``conv1_w``,
``pred_b`` ...). It renames each blob through a regex cascade into the
PyTorch state-dict convention, moves BN running statistics onto Sub-BN split
keys, reshapes or tiles blobs whose dims differ only by trailing 1s or Sub-BN
splits, and drops optimizer scratch (momentum, lr, model_iter).

No CSTS or MViT checkpoint ships in this format (the regexes cannot produce
MViT key names), so the converter stands alone: it emits a state dict of
numpy arrays in PyTorch's names, which ``torch.from_numpy`` turns into a
model's. The name cascade is a wire-format constant: each pair must match
the reference's byte for byte (c2_model_loading.py:16-110).
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

# (pattern, replacement) cascade applied in order with re.sub; every pair is a
# protocol constant from the reference (c2_model_loading.py get_name_convert_func).
_NAME_RULES: Tuple[Tuple[str, str], ...] = (
    # non-local blocks: nonlocal_conv<stage>_<idx>_{theta,g,phi,out,bn}
    (r"^nonlocal_conv([0-9]+)_([0-9]+)_(.*)", r"s\1.pathway0_nonlocal\2_\3"),
    (r"^(.*)_nonlocal([0-9]+)_(theta)(.*)", r"\1_nonlocal\2.conv_\3\4"),
    (r"^(.*)_nonlocal([0-9]+)_(g)(.*)", r"\1_nonlocal\2.conv_\3\4"),
    (r"^(.*)_nonlocal([0-9]+)_(phi)(.*)", r"\1_nonlocal\2.conv_\3\4"),
    (r"^(.*)_nonlocal([0-9]+)_(out)(.*)", r"\1_nonlocal\2.conv_\3\4"),
    (r"^(.*)_nonlocal([0-9]+)_(bn)_(.*)", r"\1_nonlocal\2.\3.\4"),
    # SlowFast lateral fusion (fast->slow subsample convs + their BNs)
    (r"^t_pool1_subsample_bn_(.*)", r"s1_fuse.bn.\1"),
    (r"^t_pool1_subsample_(.*)", r"s1_fuse.conv_f2s.\1"),
    (r"^t_res([0-9]+)_([0-9]+)_branch2c_bn_subsample_bn_(.*)", r"s\1_fuse.bn.\3"),
    (r"^t_res([0-9]+)_([0-9]+)_branch2c_bn_subsample_(.*)", r"s\1_fuse.conv_f2s.\3"),
    # slow-pathway residual blocks and stem
    (r"^res([0-9]+)_([0-9]+)_branch([0-9]+)([a-z])_(.*)",
     r"s\1.pathway0_res\2.branch\3.\4_\5"),
    (r"^res_conv1_bn_(.*)", r"s1.pathway0_stem.bn.\1"),
    (r"^conv1_xy(.*)", r"s1.pathway0_stem.conv_xy\1"),
    (r"^conv1_(.*)", r"s1.pathway0_stem.conv.\1"),
    (r"^res([0-9]+)_([0-9]+)_branch([0-9]+)_(.*)",
     r"s\1.pathway0_res\2.branch\3_\4"),
    (r"^res_conv1_(.*)", r"s1.pathway0_stem.conv.\1"),
    # fast pathway (t_ prefix) mirrors of the same
    (r"^t_res([0-9]+)_([0-9]+)_branch([0-9]+)([a-z])_(.*)",
     r"s\1.pathway1_res\2.branch\3.\4_\5"),
    (r"^t_res_conv1_bn_(.*)", r"s1.pathway1_stem.bn.\1"),
    (r"^t_conv1_(.*)", r"s1.pathway1_stem.conv.\1"),
    (r"^t_res([0-9]+)_([0-9]+)_branch([0-9]+)_(.*)",
     r"s\1.pathway1_res\2.branch\3_\4"),
    (r"^t_res_conv1_(.*)", r"s1.pathway1_stem.conv.\1"),
    # head + squeeze-excite + param-suffix canonicalization
    (r"pred_(.*)", r"head.projection.\1"),
    (r"(.*)b_bn_fc(.*)", r"\1se.fc\2"),
    (r"conv_5(.*)", r"head.conv_5\1"),
    (r"lin_5(.*)", r"head.lin_5\1"),
    (r"(.*)bn.b\Z", r"\1bn.bias"),
    (r"(.*)bn.s\Z", r"\1bn.weight"),
    (r"(.*)bn.rm\Z", r"\1bn.running_mean"),
    (r"(.*)bn.riv\Z", r"\1bn.running_var"),
    (r"(.*)[\._]b\Z", r"\1.bias"),
    (r"(.*)[\._]w\Z", r"\1.weight"),
)

# optimizer scratch blobs the reference skips silently (checkpoint.py:276-278)
_SCRATCH_SUBSTRINGS = ("momentum", "lr", "model_iter")


def convert_c2_name(name: str) -> str:
    """Caffe2 blob name -> PyTorch state-dict key (c2_model_loading.py:112-126)."""
    for pattern, repl in _NAME_RULES:
        name = re.sub(pattern, repl, name)
    return name


def c2_key_to_sub_bn(key: str, model_keys) -> str:
    """Redirect BN running stats to Sub-BN split keys when the target model uses
    them (checkpoint.py:518-535). The reference implicitly returns None when a
    ``bn.running_`` key matches neither form; we return the original key — the
    subsequent membership check fails identically either way."""
    if "bn.running_" in key and key not in model_keys:
        split = key.replace("bn.running_", "bn.split_bn.running_")
        if split in model_keys:
            return split
    return key


def load_caffe2_pickle(path: str) -> Dict[str, np.ndarray]:
    """Read a Caffe2 checkpoint pickle -> raw blob dict (checkpoint.py:221-223)."""
    with open(path, "rb") as f:
        ckpt = pickle.load(f, encoding="latin1")
    return dict(ckpt["blobs"])


def convert_caffe2_checkpoint(
    path: str,
    model_shapes: Optional[Mapping[str, Tuple[int, ...]]] = None,
) -> Dict[str, np.ndarray]:
    """Caffe2 pickle -> torch-convention state dict of numpy arrays.

    ``model_shapes`` maps target state-dict keys to shapes (a torch model's
    ``{k: tuple(v.shape)}``). When given, the reference's shape adaptations run
    (checkpoint.py:231-258): trailing-1 dim expansion (linear->conv) and 1-D
    BN-stat tiling onto larger Sub-BN stats; blobs whose adapted shape still
    mismatches, or whose converted name is absent, are dropped exactly as the
    reference drops them (it warns and loads non-strict). Without
    ``model_shapes``, every non-scratch blob is returned under its converted name.
    """
    blobs = load_caffe2_pickle(path)
    out: Dict[str, np.ndarray] = {}
    for name, blob in blobs.items():
        if any(s in name for s in _SCRATCH_SUBSTRINGS):
            continue
        blob = np.asarray(blob)
        key = convert_c2_name(name)
        if model_shapes is None:
            out[key] = blob
            continue
        key = c2_key_to_sub_bn(key, model_shapes)
        if key not in model_shapes:
            continue
        want = tuple(model_shapes[key])
        if blob.ndim < len(want):
            blob = blob.reshape(blob.shape + (1,) * (len(want) - blob.ndim))
        if (
            blob.ndim == 1
            and len(want) == 1
            and want[0] > blob.shape[0]
            and want[0] % blob.shape[0] == 0
        ):
            blob = np.concatenate([blob] * (want[0] // blob.shape[0]))
        if tuple(blob.shape) == want:
            out[key] = blob
    return out

"""What the drivers share about the program under test: its configuration
built from a configuration file's keys, the card's memory peak, and the
comparisons of its outputs with the reference's."""

from __future__ import annotations

import gc
from typing import Dict, List

import torch


def program_cfg(keys: Dict):
    """``csts_torch.config.get_cfg()`` with every key of the file set on it,
    so a change of the program's presets or defaults cannot move the cell."""
    from csts_torch.config import get_cfg

    cfg = get_cfg()
    for dotted, value in keys.items():
        section, key = dotted.split(".")
        node = getattr(cfg, section)
        if not hasattr(node, key):
            raise KeyError(f"the program's config has no {dotted}")
        setattr(node, key, value)
    return cfg


def compute_dtype(keys: Dict) -> torch.dtype:
    return torch.bfloat16 if keys["TRAIN.MIXED_PRECISION"] else torch.float32


def free(device: torch.device) -> None:
    """Drop what the caller released, so that the reference finds the card empty."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def reference_mode() -> None:
    """fp32 products in fp32 (no TF32), for the reference only, after the window."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def heatmap_gap(served: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst frame's total-variation distance between served and
    reference per-frame heatmaps (..., T, H, W[, 1]): half the summed
    absolute difference of the two distributions, in [0, 1]."""
    s = served.float().reshape(*served.shape[:2], -1)
    r = ref.float().reshape(*ref.shape[:2], -1)
    return float(0.5 * (s - r).abs().sum(-1).max())


def logit_gap(served: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst clip's largest logit difference over that clip's largest
    reference logit magnitude."""
    d = (served.float() - ref.float()).abs().amax(-1)
    return float((d / ref.float().abs().amax(-1)).max())


def norm_gap(prog: Dict[str, float], ref: Dict[str, float], names: List[str],
             q: float = 1.0) -> float:
    """Each leaf of ``names``: |‖program‖ − ‖reference‖| over the larger of
    the reference's norm of that leaf and of the median leaf; the worst
    leaf's, or with ``q`` < 1 the leaf's at that quantile (nearest rank below)."""
    med = sorted(ref[n] for n in names)[len(names) // 2]
    gaps = sorted(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)
    return gaps[int(q * (len(gaps) - 1))]

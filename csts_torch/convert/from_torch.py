"""Fine-tune initialisation from reference ``.pyth`` checkpoints (the port's
counterpart of ``csts_tpu/convert/from_torch.py`` and the partial loads of
``csts_tpu/utils/checkpoint.py``; reference ``slowfast/utils/checkpoint.py``
:146-182, :327-335, :357-474).

The port's parameters carry the reference's names, so a ``.pyth`` state dict
(``utils/checkpoint.load_state_dict_file`` reads one) needs no renaming:
what it holds is merged into the model leaf by leaf.

* A leaf whose shape matches is copied. A position embedding whose token
  count differs (a 224² pretrain on 256² crops) is interpolated linearly
  over the token axis with half-pixel centres, as ``F.interpolate(...,
  mode='linear')`` does. Every other leaf keeps its initialisation; the
  counts are logged.
* An audio-pretrained MViT merges into the audio branch: ``blocks.*`` ->
  ``blocks_audio.*``, ``patch_embed.*`` -> ``patch_embed_audio.*``,
  ``pos_embed*`` -> ``pos_embed*_audio``; its other keys are dropped.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from csts_torch.utils.logging import get_logger

logger = get_logger(__name__)


def interpolate_pos_embed(pos_embed: np.ndarray, target_len: int) -> np.ndarray:
    """A (1, L, C) position embedding resampled to ``target_len`` tokens:
    linear over the token axis, half-pixel centres, edges clamped."""
    pos_embed = np.asarray(pos_embed)
    if pos_embed.shape[1] == target_len:
        return pos_embed
    src_len = pos_embed.shape[1]
    x = np.clip((np.arange(target_len) + 0.5) * (src_len / target_len) - 0.5, 0, src_len - 1)
    lo = np.floor(x).astype(int)
    hi = np.minimum(lo + 1, src_len - 1)
    frac = (x - lo)[:, None]
    out = pos_embed[0, lo] * (1 - frac) + pos_embed[0, hi] * frac
    return out[None].astype(pos_embed.dtype)


def merge_partial(model: nn.Module, sd: Mapping[str, torch.Tensor]) -> Tuple[int, int]:
    """Copies what ``sd`` holds into ``model``'s parameters, in place (the
    optimizer's references stay valid): matching shapes, and position
    embeddings interpolated over the token axis. Returns (loaded, kept):
    the parameters taken from ``sd`` and those that kept their values."""
    loaded = kept = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name not in sd:
                kept += 1
                continue
            src = sd[name].detach().cpu()
            if tuple(src.shape) == tuple(p.shape):
                p.copy_(src.to(p.dtype))
                loaded += 1
            elif ("pos_embed" in name and src.dim() == 3 and src.shape[0] == 1
                  and p.dim() == 3 and src.shape[2] == p.shape[2]):
                interp = interpolate_pos_embed(src.float().numpy(), p.shape[1])
                p.copy_(torch.from_numpy(interp).to(p.dtype))
                logger.info("Interpolated %s from %s to %s", name, tuple(src.shape),
                            tuple(p.shape))
                loaded += 1
            else:
                logger.info("Skipping %s: checkpoint %s vs model %s", name, tuple(src.shape),
                            tuple(p.shape))
                kept += 1
    return loaded, kept


def audio_branch_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An audio-pretrained MViT's state dict under the audio branch's names."""
    out = {}
    for k, v in sd.items():
        if k.startswith("blocks."):
            out["blocks_audio." + k[len("blocks."):]] = v
        elif k.startswith("patch_embed."):
            out["patch_embed_audio." + k[len("patch_embed."):]] = v
        elif k.startswith("pos_embed"):
            out[k if k.endswith("_audio") else k + "_audio"] = v
    return out

"""Linear, MLP, exact GELU and stochastic depth (``csts_tpu/ops/common.py``).

Weights are in PyTorch's ``nn.Linear`` layout, ``(out, in)``. Matrix products
accumulate in fp32 (fp32 products stay full fp32: TF32 is off for
``torch.matmul`` unless a caller turns it on). ``F.linear`` adds the bias in
the product's epilogue, before the one rounding to a bf16 result, where the
JAX package rounds the product and then adds: at most one bf16 ulp apart.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch's ``nn.GELU()`` default."""
    return F.gelu(x, approximate="none")


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def mlp(
    x: torch.Tensor,
    fc1_w: torch.Tensor,
    fc1_b: Optional[torch.Tensor],
    fc2_w: torch.Tensor,
    fc2_b: Optional[torch.Tensor],
) -> torch.Tensor:
    """fc1 → GELU → fc2 (the reference's ``Mlp``)."""
    return linear(gelu(linear(x, fc1_w, fc1_b)), fc2_w, fc2_b)


def drop_path(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Stochastic depth per sample (``csts_tpu/ops/common.py`` ``drop_path``)
    with the mask given: ``mask`` (B,) is bernoulli(keep) / keep, already
    divided, so the branch is x · mask."""
    return x * mask.to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))


def sample_drop_masks(
    spec, batch: int, generator: torch.Generator, device=None
) -> List[Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Per video block of ``spec`` (a ``CSTSSpec``), the stochastic-depth
    masks of one training step: None where the block's rate is 0, else
    (attention-branch mask, MLP-branch mask), each fp32 (batch,) of
    bernoulli(1 - rate) / (1 - rate). Drawn from ``generator`` (a CPU
    generator, so the masks do not depend on the device) and moved to
    ``device``. The audio, fusion and decoder blocks have rate 0."""
    masks: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = []
    for blk in spec.video_blocks:
        if blk.drop_path == 0.0:
            masks.append(None)
            continue
        keep = 1.0 - blk.drop_path
        pair = tuple((torch.rand(batch, generator=generator) < keep).float().div_(keep).to(device)
                     for _ in range(2))
        masks.append(pair)
    return masks

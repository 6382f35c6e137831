"""LayerNorm with fp32 statistics whatever the activation dtype
(``csts_tpu/ops/norm.py``).

The blocks use eps 1e-6 (``nn.LayerNorm(dim, eps=1e-6)`` in the reference);
the q/k/v pool norms use torch's default 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Normalise over the last axis. ``F.layer_norm`` keeps its statistics and
    the affine map in fp32 for a bf16 input and rounds the result once."""
    return F.layer_norm(x, x.shape[-1:], weight.to(x.dtype), bias.to(x.dtype), eps)

"""Linear, MLP and exact GELU (``csts_tpu/ops/common.py``).

Weights are in PyTorch's ``nn.Linear`` layout, ``(out, in)``. Matrix products
accumulate in fp32 (fp32 products stay full fp32: TF32 is off for
``torch.matmul`` unless a caller turns it on). ``F.linear`` adds the bias in
the product's epilogue, before the one rounding to a bf16 result, where the
JAX package rounds the product and then adds: at most one bf16 ulp apart.
"""

from __future__ import annotations

from typing import Optional

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

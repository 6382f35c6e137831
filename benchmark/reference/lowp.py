"""The control's precision: the reference run with every product's and
convolution's operands in fp8 (e4m3, 3 mantissa bits), the step below the
configurations' bf16 that would tempt a change. Each operand is scaled per
tensor so that its largest magnitude lands on fp8's largest (448), rounded
to fp8 and scaled back, as an fp8 GEMM with per-tensor scales reads it;
products then sum in fp32. Under autograd the gradient that flows back
through a rounded operand is rounded the same way (the backward's products
in fp8 too).
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x scaled per tensor into e4m3's range, rounded, scaled back (fp32)."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The operand rounding of the fp8 control (differentiable)."""
    return _RoundFP8.apply(x) if torch.is_grad_enabled() and x.requires_grad else round_fp8(x)

"""K2: the MLP tail of an MViT block, LN2 → fc1 → GELU → fc2, plus the base
(``proj(LN2(x))`` when dim ≠ dim_out, else x).

Port of ``csts_tpu/kernels/block.py`` ``_mlp_tail_kernel`` only; the
whole-block kernels of that module come in a later part of the port. On a
CUDA tensor :func:`fused_mlp_tail` launches ``csrc/mlp_tail.cu``; on a CPU
tensor it runs :func:`fused_mlp_tail_plain`. Weights are in ``nn.Linear``
layout, (out, in).
"""

from __future__ import annotations

from typing import Optional

import torch

from csts_torch.kernels import _build
from csts_torch.ops.common import gelu

LN_EPS = 1e-6


def fused_mlp_tail_plain(
    x: torch.Tensor,
    ln_w: torch.Tensor, ln_b: torch.Tensor,
    fc1_w: torch.Tensor, fc1_b: torch.Tensor,
    fc2_w: torch.Tensor, fc2_b: torch.Tensor,
    proj_w: Optional[torch.Tensor] = None, proj_b: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points: fp32 LN2
    statistics, LN2(x) and GELU(hidden) rounded to x's dtype before their
    products, fp32 accumulation and bias adds, one rounding of the result."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    centered = x32 - mean
    var = centered.square().mean(dim=-1, keepdim=True)
    xn = centered * torch.rsqrt(var + LN_EPS) * ln_w.float() + ln_b.float()
    xn = xn.to(x.dtype).float()
    hid = torch.matmul(xn, fc1_w.float().t()) + fc1_b.float()
    hid = gelu(hid).to(x.dtype).float()
    mlp = torch.matmul(hid, fc2_w.float().t()) + fc2_b.float()
    if proj_w is not None:
        base = torch.matmul(xn, proj_w.float().t()) + proj_b.float()
    else:
        base = x32
    return (base + mlp).to(x.dtype)


def fused_mlp_tail(
    x: torch.Tensor,
    ln_w: torch.Tensor, ln_b: torch.Tensor,
    fc1_w: torch.Tensor, fc1_b: torch.Tensor,
    fc2_w: torch.Tensor, fc2_b: torch.Tensor,
    proj_w: Optional[torch.Tensor] = None, proj_b: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x: (B, L, C) residual-complete attention output -> (B, L, dim_out)."""
    if x.device.type == "cpu":
        return fused_mlp_tail_plain(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, proj_w, proj_b)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_tail: unsupported device {x.device}")
    if (proj_w is None) != (proj_b is None):
        raise ValueError("fused_mlp_tail: proj weight and bias go together")
    params = [ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b]
    if proj_w is not None:
        params += [proj_w, proj_b]
    _build.check_cuda_inputs("fused_mlp_tail", x, *params)
    *lead, c = x.shape
    hidden, cout = fc1_w.shape[0], fc2_w.shape[0]
    if fc1_w.shape != (hidden, c) or fc2_w.shape != (cout, hidden):
        raise ValueError(f"fused_mlp_tail: fc1 {tuple(fc1_w.shape)} / fc2 "
                         f"{tuple(fc2_w.shape)} do not fit width {c}")
    if proj_w is None and cout != c:
        raise ValueError("fused_mlp_tail: dim != dim_out needs the proj weights")
    if proj_w is not None and proj_w.shape != (cout, c):
        raise ValueError(f"fused_mlp_tail: proj {tuple(proj_w.shape)} is not ({cout}, {c})")
    if c % 16 or hidden % 16 or cout % 16:
        raise ValueError(f"fused_mlp_tail: widths {c}/{hidden}/{cout} must be multiples of 16")
    # the kernel copies 16-byte pieces of the rows (cp.async)
    x2, *params = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (x.reshape(-1, c).contiguous(), *(p.contiguous() for p in params)))
    m = x2.shape[0]
    wp, bp = (params[6], params[7]) if proj_w is not None else (None, None)
    out = torch.empty((m, cout), dtype=x.dtype, device=x.device)
    fn = _build.function("mlp_tail", "csts_mlp_tail")
    err = fn(
        _build.dtype_code(x), x2.data_ptr(),
        *(t.data_ptr() for t in params[:6]),
        wp.data_ptr() if wp is not None else None,
        bp.data_ptr() if bp is not None else None,
        out.data_ptr(), m, c, hidden, cout, LN_EPS, _build.stream_ptr(x),
    )
    _build.check_launch("fused_mlp_tail", err)
    fused_mlp_tail.launches += 1
    return out.reshape(*lead, cout)


fused_mlp_tail.launches = 0

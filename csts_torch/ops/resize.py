"""Half-pixel trilinear resize (``csts_tpu/ops/resize.py``).

For upsampling this equals ``jax.image.resize(method='linear')``: both sample
at half-pixel centres and clamp at the edges, which is torch's
``F.interpolate(mode='trilinear', align_corners=False)``. The model only
upsamples (the decoder's (1,2,2) skips), so no antialiasing question arises.
The interpolation runs in fp32 and rounds once to the input dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

# The JAX package's switch between two XLA lowerings of this resize
# (``csts_tpu/ops/resize.py:36``). ``tools/ab_flags`` lists it so that a
# config names the same switches in both packages; nothing here reads it,
# as the port has one lowering (separable, the switch's default side).
SPLIT_AXES_T_FIRST = True


def upsample2x(g: torch.Tensor, axis: int) -> torch.Tensor:
    """x2 half-pixel linear upsampling of ``g`` along ``axis``, in g's dtype:
    out[2m] = 0.25·g[m-1] + 0.75·g[m], out[2m+1] = 0.75·g[m] + 0.25·g[m+1],
    with the clamped edge planes exact copies."""
    n = g.shape[axis]
    m = torch.arange(n, device=g.device)
    prev = g.index_select(axis, (m - 1).clamp(min=0))
    nxt = g.index_select(axis, (m + 1).clamp(max=n - 1))
    even = prev * 0.25 + g * 0.75
    odd = g * 0.75 + nxt * 0.25
    even.narrow(axis, 0, 1).copy_(g.narrow(axis, 0, 1))
    odd.narrow(axis, n - 1, 1).copy_(g.narrow(axis, n - 1, 1))
    shape = list(g.shape)
    shape[axis] = 2 * n
    return torch.stack([even, odd], dim=axis + 1).reshape(shape)


def trilinear_resize(x: torch.Tensor, size_thw: Sequence[int]) -> torch.Tensor:
    """``x``: (B, T, H, W, C) -> (B, *size_thw, C).

    Trilinear weights are separable, so an axis that doubles takes
    :func:`upsample2x` (the model's decoder skips); other sizes go through
    ``F.interpolate`` on a contiguous NCDHW copy."""
    size = tuple(int(s) for s in size_thw)
    if all(s in (n, 2 * n) for s, n in zip(size, x.shape[1:4])):
        g = x.float()
        for axis, (s, n) in enumerate(zip(size, x.shape[1:4]), start=1):
            if s == 2 * n:
                g = upsample2x(g, axis)
        return g.to(x.dtype)
    y = F.interpolate(
        x.permute(0, 4, 1, 2, 3).float().contiguous(), size=size, mode="trilinear",
        align_corners=False,
    )
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)

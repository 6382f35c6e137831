"""The skip upsample kernels of ``csts_tpu/kernels/upsample.py``.

* K3 :func:`t2_upsample` (``_t2_kernel``, ``t2_upsample_padded`` without its
  128-lane padding): x2 half-pixel linear interpolation along T. It serves
  d4's stride-(2,1,1) skip and the stem-skip T-resize at the head; a
  sliding window over T, one thread a 16-byte piece of a clip's plane
  (:func:`t2_upsample_window_plain` is the plain model of that plan).
* B9a :func:`hw2_upsample` (``_hw2_kernel``): x2 along H, then x2 along W,
  the stride-(1,2,2) skips of d2 and d3, taken only when
  :data:`HW2_SKIP_KERNEL` is set (the JAX package's switch, with its name
  and default). Eval only, as in JAX: no backward.

On a CUDA tensor each wrapper launches ``csrc/upsample.cu``; on a CPU
tensor it runs its ``*_plain`` twin.

Training goes through :func:`t2_upsample_train` (the autograd Function
:class:`T2Upsample`): K3 forward, and backward the adjoint of the
interpolation in plain PyTorch (:func:`t2_upsample_adjoint`); the JAX
package has no backward kernel for it (its resize's gradient is XLA's).
"""

from __future__ import annotations

from typing import Sequence

import torch

from csts_torch.kernels import _build
from csts_torch.ops.resize import upsample2x

# The JAX package's experiment switch (``csts_tpu/kernels/upsample.py:54``),
# read by the decoder's whole-block route (``models/mvit.py``): its
# stride-(1,2,2) skips go through B9a when set. Off by default, as in JAX,
# where it measured as a loss on the TPU; ``python -m
# csts_torch.tools.ab_flags --configs base hw2_skip`` measures it here.
HW2_SKIP_KERNEL = False


def t2_upsample_plain(x: torch.Tensor, thw: Sequence[int]) -> torch.Tensor:
    """x: (B, T·H·W, C) on the (T, H, W) grid -> (B, 2T·H·W, C).

    out[2m] = 0.25·x[m-1] + 0.75·x[m], out[2m+1] = 0.75·x[m] + 0.25·x[m+1] in
    fp32 with one rounding; the clamped edge planes are exact copies."""
    b, l, c = x.shape
    t = int(thw[0])
    g = x.reshape(b, t, l // t * c).float()
    return upsample2x(g, 1).reshape(b, 2 * l, c).to(x.dtype)


def t2_upsample_window_plain(x: torch.Tensor, thw: Sequence[int]) -> torch.Tensor:
    """Plain model of K3's sliding window (``csrc/upsample.cu``
    ``t2_upsample_kernel``): each clip's planes walked in order with the
    window (x[m-1], x[m], x[m+1]); out[2m] is a copy of x[0] at m = 0, else
    0.25·x[m-1] + 0.75·x[m], and out[2m+1] a copy of x[T-1] at the last
    plane, else 0.75·x[m] + 0.25·x[m+1], each product and the sum rounded on
    their own in fp32, then once to x's dtype. Same shapes as
    :func:`t2_upsample_plain`."""
    b, l, c = x.shape
    t = int(thw[0])
    g = x.reshape(b, t, l // t * c)
    cur = g[:, 0]
    prev, outs = cur, []
    for m in range(t):
        nxt = g[:, m + 1] if m + 1 < t else cur
        c32 = cur.float()
        outs.append(cur if m == 0 else (prev.float() * 0.25 + c32 * 0.75).to(x.dtype))
        outs.append(cur if m + 1 == t else (c32 * 0.75 + nxt.float() * 0.25).to(x.dtype))
        prev, cur = cur, nxt
    return torch.stack(outs, dim=1).reshape(b, 2 * l, c)


def t2_upsample(x: torch.Tensor, thw: Sequence[int]) -> torch.Tensor:
    """x: (B, T·H·W, C) tokens -> (B, 2T·H·W, C), see :func:`t2_upsample_plain`."""
    if x.device.type == "cpu":
        return t2_upsample_plain(x, thw)
    if x.device.type != "cuda":
        raise ValueError(f"t2_upsample: unsupported device {x.device}")
    _build.check_cuda_inputs("t2_upsample", x)
    b, l, c = x.shape
    t = int(thw[0])
    if l % t:
        raise ValueError(f"t2_upsample: {l} tokens do not split into {t} planes")
    x = x.contiguous()
    out = torch.empty((b, 2 * l, c), dtype=x.dtype, device=x.device)
    fn = _build.function("upsample", "csts_t2_upsample")
    err = fn(_build.dtype_code(x), x.data_ptr(), out.data_ptr(), b, t, l // t * c,
             _build.stream_ptr(x))
    _build.check_launch("t2_upsample", err)
    t2_upsample.launches += 1
    return out


t2_upsample.launches = 0


def hw2_upsample_plain(x: torch.Tensor, thw: Sequence[int]) -> torch.Tensor:
    """x: (B, T·H·W, C) on the (T, H, W) grid -> (B, T·2H·2W, C).

    The JAX kernel's two passes and rounding points: x2 along H in fp32,
    rounded to x's dtype, then x2 along W in fp32, rounded again. The
    clamped edges are copies (the JAX kernel's 0.25·a + 0.75·a there is the
    same value up to one fp32 rounding, and exactly in bf16)."""
    b, l, c = x.shape
    t, h, w = (int(s) for s in thw)
    g = upsample2x(x.reshape(b * t, h, w, c).float(), 1).to(x.dtype).float()
    return upsample2x(g, 2).reshape(b, 4 * l, c).to(x.dtype)


def hw2_upsample(x: torch.Tensor, thw: Sequence[int]) -> torch.Tensor:
    """B9a. x: (B, T·H·W, C) tokens -> (B, T·2H·2W, C), see
    :func:`hw2_upsample_plain`. Any T, H, W and C."""
    if x.device.type == "cpu":
        return hw2_upsample_plain(x, thw)
    if x.device.type != "cuda":
        raise ValueError(f"hw2_upsample: unsupported device {x.device}")
    _build.check_cuda_inputs("hw2_upsample", x)
    b, l, c = x.shape
    t, h, w = (int(s) for s in thw)
    if l != t * h * w:
        raise ValueError(f"hw2_upsample: {l} tokens are not the grid {tuple(thw)}")
    x = x.contiguous()
    out = torch.empty((b, 4 * l, c), dtype=x.dtype, device=x.device)
    fn = _build.function("upsample", "csts_hw2_upsample")
    err = fn(_build.dtype_code(x), x.data_ptr(), out.data_ptr(), b * t, h, w, c,
             _build.stream_ptr(x))
    _build.check_launch("hw2_upsample", err)
    hw2_upsample.launches += 1
    return out


hw2_upsample.launches = 0


def t2_upsample_adjoint(g: torch.Tensor, thw: Sequence[int]) -> torch.Tensor:
    """The gradient of :func:`t2_upsample` for the output gradient g
    (B, 2T·H·W, C): each output plane's taps folded back onto its source
    planes, 0.75 on plane m from outputs 2m and 2m+1, 0.25 on plane m-1 from
    output 2m and on plane m+1 from output 2m+1, clamped at the edges (the
    edge copies are the clamped taps summed). fp32, one rounding to g's
    dtype. Returns (B, T·H·W, C)."""
    b, l2, c = g.shape
    t = int(thw[0])
    gg = g.reshape(b, t, 2, l2 // (2 * t) * c).float()
    even, odd = gg[:, :, 0], gg[:, :, 1]
    gx = 0.75 * (even + odd)
    gx[:, :-1] += 0.25 * even[:, 1:]
    gx[:, 0] += 0.25 * even[:, 0]
    gx[:, 1:] += 0.25 * odd[:, :-1]
    gx[:, -1] += 0.25 * odd[:, -1]
    return gx.reshape(b, l2 // 2, c).to(g.dtype)


class T2Upsample(torch.autograd.Function):
    """K3 forward, its plain adjoint backward, on both devices."""

    @staticmethod
    def forward(ctx, x, thw):
        ctx.thw = tuple(int(s) for s in thw)
        return t2_upsample(x, thw)

    @staticmethod
    def backward(ctx, g):
        return t2_upsample_adjoint(g, ctx.thw), None


def t2_upsample_train(x: torch.Tensor, thw: Sequence[int]) -> torch.Tensor:
    """:func:`t2_upsample` inside autograd (see :class:`T2Upsample`)."""
    return T2Upsample.apply(x, thw)

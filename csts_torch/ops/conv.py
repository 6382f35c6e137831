"""3-D convolution and pooling on channels-last grids (``csts_tpu/ops/conv.py``).

Activations keep the JAX package's layout, ``(B, T, H, W, C)``; weights keep
PyTorch's, ``(C_out, C_in / groups, kT, kH, kW)`` (a ``ConvTranspose3d`` weight
is ``(C_in, C_out / groups, kT, kH, kW)``). A permuted view of a contiguous
channels-last grid is PyTorch's ``channels_last_3d`` format, so the convolution
reads it without a copy.

These are the convolutions the JAX package leaves to XLA outside its Pallas
kernels; here they go to ``F.conv3d`` / ``F.linear`` / ``F.max_pool3d``, in
the forms cuDNN runs fast on the H100 (timed per op at the flagship's shapes,
PERF.md): the depthwise conv reads a contiguous NCDHW copy (cuDNN's 3-D
depthwise kernels are several times slower on channels-last views), the
transposed depthwise conv is that depthwise conv over a zero-stuffed input
with the flipped kernel, and a conv whose window covers the whole frame is a
matmul per frame. An fp32 convolution on CUDA runs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False, which a parity check sets.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def _to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    # contiguous channels-last out, whatever memory format the backend chose
    # (a no-op when it kept channels_last_3d), so the tokens that follow keep
    # a unit channel stride
    return x.permute(0, 2, 3, 4, 1).contiguous()


def _ints(v: Sequence[int]):
    return tuple(int(a) for a in v)


def conv3d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    stride: Sequence[int],
    padding: Sequence[int],
    groups: int = 1,
) -> torch.Tensor:
    """Standard conv: (B, T, H, W, C_in) -> (B, T', H', W', C_out)."""
    b, t, h, w, c = x.shape
    c_out, _, kt, kh, kw = weight.shape
    if groups == 1 and (kt, kh, kw) == (1, h, w) and not any(int(p) for p in padding):
        # the window covers the whole frame (the fusion's pools, the classifier
        # of a 1x1 grid): one matmul per frame over its (c, h, w) values, the
        # weight's own order (the frame is far smaller than the weight to permute)
        frames = x.permute(0, 1, 4, 2, 3).reshape(b * t, -1)
        out = F.linear(frames, weight.to(x.dtype).reshape(c_out, -1),
                       None if bias is None else bias.to(x.dtype))
        return out.reshape(b, t, 1, 1, c_out)
    out = F.conv3d(
        _to_ncdhw(x), weight.to(x.dtype), None, _ints(stride), _ints(padding), 1, groups
    )
    out = _to_ndhwc(out)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def depthwise_conv3d(
    x: torch.Tensor, weight: torch.Tensor, stride: Sequence[int], padding: Sequence[int]
) -> torch.Tensor:
    """Depthwise conv (groups == channels), the q/k/v pooling op.

    ``x``: (B, T, H, W, C); ``weight``: (C, 1, kT, kH, kW), no bias — the
    reference's per-head ``nn.Conv3d(hd, hd, groups=hd, bias=False)``. A
    channels-last view of NCDHW-contiguous memory is read without a copy.
    """
    c = x.shape[-1]
    out = F.conv3d(_to_ncdhw(x).contiguous(), weight.to(x.dtype), None, _ints(stride),
                   _ints(padding), 1, c)
    return _to_ndhwc(out)


def depthwise_conv_transpose3d(
    x: torch.Tensor,
    weight: torch.Tensor,
    stride: Sequence[int],
    padding: Sequence[int],
    output_padding: Sequence[int],
) -> torch.Tensor:
    """Depthwise transposed conv, the decoder's Q upsample: the reference's
    ``nn.ConvTranspose3d(hd, hd, groups=hd, bias=False)`` with
    ``output_padding``. ``weight``: (C, 1, kT, kH, kW).

    Computed as the depthwise conv of the input spread on a ``stride`` grid of
    zeros, edged with ``k - 1 - padding`` zeros (``+ output_padding`` at the
    high end), with the kernel flipped in all three axes."""
    b, c = x.shape[0], x.shape[-1]
    kernel, stride = weight.shape[2:], _ints(stride)
    spread = [(n - 1) * s + 1 for n, s in zip(x.shape[1:4], stride)]
    lo = [k - 1 - int(p) for k, p in zip(kernel, padding)]
    size = [n + 2 * e + int(o) for n, e, o in zip(spread, lo, output_padding)]
    z = x.new_zeros((b, c, *size))  # NCDHW memory, what the depthwise conv reads
    z[:, :, lo[0]:lo[0] + spread[0]:stride[0], lo[1]:lo[1] + spread[1]:stride[1],
      lo[2]:lo[2] + spread[2]:stride[2]] = _to_ncdhw(x)
    return depthwise_conv3d(z.permute(0, 2, 3, 4, 1), weight.flip(2, 3, 4), (1, 1, 1), (0, 0, 0))


def max_pool3d(
    x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int], padding: Sequence[int]
) -> torch.Tensor:
    """MaxPool3d with implicit -inf padding (padding never wins the max)."""
    out = F.max_pool3d(_to_ncdhw(x), _ints(kernel), _ints(stride), _ints(padding))
    return _to_ndhwc(out)

"""K1: the multiscale attention core, softmax(q kᵀ · scale [+ mask]) v.

Port of ``csts_tpu/kernels/attention.py`` (``_attn_kernel``). On a CUDA
tensor :func:`fused_attention` launches the hand-written kernel in
``csrc/attention.cu`` (mma.sync bf16 products with fp32 accumulation, online
softmax over key chunks, probabilities kept in registers); on a CPU
tensor it runs :func:`fused_attention_plain`, the same function in plain
PyTorch. There is no other route.
"""

from __future__ import annotations

from typing import Optional

import torch

from csts_torch.kernels import _build


# head dims the kernel is compiled for (the flagship uses 96, and 192 at d2)
HEAD_DIMS = (64, 96, 128, 192)


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """t if its rows are unit-stride and start on 16-byte boundaries (the
    kernel copies 16-byte pieces of them), else a contiguous copy."""
    aligned = (t.stride(-1) == 1 and all(st % 8 == 0 for st in t.stride()[:-1])
               and t.data_ptr() % 16 == 0)
    return t if aligned else t.clone(memory_format=torch.contiguous_format)


def fused_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version with the kernel's numerics: fp32 logits and
    softmax, probabilities rounded to v's dtype, fp32-accumulated P·V, one
    rounding of the output. q: (B, N, Lq, hd); k, v: (B, N, Lk, hd);
    mask: additive fp32 (Lq, Lk). Returns (B, N, Lq, hd)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q kᵀ · scale [+ mask]) v, probabilities never in device memory.

    q: (B, N, Lq, hd); k, v: (B, N, Lk, hd), any strides (head views of a
    fused qkv projection pass without a copy; unaligned rows are copied);
    mask: additive (Lq, Lk), broadcast over batch and heads. Returns
    (B, N, Lq, hd); on CUDA it is a view of a token-major (B, Lq, N·hd)
    buffer, so merging the heads afterwards is free.
    """
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, scale, mask)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    _build.check_cuda_inputs("fused_attention", q, k, v)
    b, n, lq, hd = q.shape
    lk = k.shape[2]
    if k.shape != (b, n, lk, hd) or v.shape != k.shape:
        raise ValueError(f"fused_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"fused_attention: head dim {hd} is not one of {HEAD_DIMS}")
    if b * n > 65535:
        raise ValueError("fused_attention: batch·heads above 65535")
    q, k, v = (_rows16(t) for t in (q, k, v))
    if mask is not None:
        if mask.shape != (lq, lk):
            raise ValueError(f"fused_attention: mask {tuple(mask.shape)} is not ({lq}, {lk})")
        mask = mask.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty((b, lq, n, hd), dtype=q.dtype, device=q.device)
    fn = _build.function("attention", "csts_attention_fwd")
    err = fn(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        b, n, lq, lk, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        lq * n * hd, hd, n * hd,
        float(scale), _build.stream_ptr(q),
    )
    _build.check_launch("fused_attention", err)
    fused_attention.launches += 1
    return out.permute(0, 2, 1, 3)


fused_attention.launches = 0

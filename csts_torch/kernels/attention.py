"""K1 and B8: the multiscale attention core, softmax(q kᵀ · scale [+ mask]) v,
and its backward.

Port of ``csts_tpu/kernels/attention.py``: ``_attn_kernel`` (K1) and
``_flash_bwd_kernel`` (B8). On a CUDA tensor :func:`fused_attention` launches
the hand-written kernel in ``csrc/attention.cu`` (mma.sync bf16 products with
fp32 accumulation, online softmax over key chunks, probabilities kept in
registers) and :func:`fused_attention_bwd` the one in
``csrc/attention_bwd.cu``; on a CPU tensor each runs its ``*_plain`` twin,
the same function in plain PyTorch. There is no other route.

Training goes through :func:`attention_train` (the autograd Function
:class:`FusedAttention`): unmasked sites run K1 forward, which then also
writes each row's log-sum-exp, and B8 backward, as the JAX package's
``_fwd``/``_bwd`` do with its kernels on; a masked site (the spatial fusion)
runs K1 forward and recomputes the probabilities in plain PyTorch backward,
as JAX's XLA fallback does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from csts_torch.kernels import _build


# head dims the kernels are compiled for (the flagship uses 96, and 192 at d2)
HEAD_DIMS = (64, 96, 128, 192)


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """t if its rows are unit-stride and start on 16-byte boundaries (the
    kernel copies 16-byte pieces of them), else a contiguous copy."""
    aligned = (t.stride(-1) == 1 and all(st % 8 == 0 for st in t.stride()[:-1])
               and t.data_ptr() % 16 == 0)
    return t if aligned else t.clone(memory_format=torch.contiguous_format)


def _check_shapes(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    b, n, _, hd = q.shape
    lk = k.shape[2]
    if k.shape != (b, n, lk, hd) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} is not one of {HEAD_DIMS}")
    if b * n > 65535:
        raise ValueError(f"{name}: batch·heads above 65535")


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


def _attention_fwd(q, k, v, scale, mask, with_lse: bool):
    """K1 on CUDA tensors: (out, lse), lse the fp32 (B·N, Lq) log-sum-exp of
    each row's logits when ``with_lse``, else None."""
    _build.check_cuda_inputs("fused_attention", q, k, v)
    _check_shapes("fused_attention", q, k, v)
    b, n, lq, hd = q.shape
    lk = k.shape[2]
    q, k, v = (_rows16(t) for t in (q, k, v))
    if mask is not None:
        if mask.shape != (lq, lk):
            raise ValueError(f"fused_attention: mask {tuple(mask.shape)} is not ({lq}, {lk})")
        mask = mask.to(device=q.device, dtype=torch.float32).contiguous()
    out = torch.empty((b, lq, n, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * n, lq), dtype=torch.float32, device=q.device) if with_lse else None
    fn = _build.function("attention", "csts_attention_fwd")
    err = fn(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, n, lq, lk, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        lq * n * hd, hd, n * hd,
        float(scale), _build.stream_ptr(q),
    )
    _build.check_launch("fused_attention", err)
    fused_attention.launches += 1
    return out.permute(0, 2, 1, 3), lse


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
    return _attention_fwd(q, k, v, scale, mask, with_lse=False)[0]


fused_attention.launches = 0


# ----------------------------------------------------------------------------------
# B8: the backward
# ----------------------------------------------------------------------------------


def fused_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
    scale: float, lse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B8 with the kernel's rounding points: fp32
    logits and softmax (recomputed here; ``lse`` is the kernel's shortcut and
    is not read), delta = rowsum(g·out) and dl = p·(g vᵀ − delta) in fp32, p
    and dl rounded to q's dtype before the products dv = pᵀ g, dq = dl k ·
    scale and dk = dlᵀ q · scale, each accumulated in fp32 and rounded once.
    Returns (dq, dk, dv) in the inputs' dtype."""
    dt = q.dtype
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)
    g32 = g.float()
    delta = (g32 * out.float()).sum(dim=-1, keepdim=True)
    dl = p * (torch.matmul(g32, v.float().transpose(-1, -2)) - delta)
    p, dl = p.to(dt).float(), dl.to(dt).float()
    dq = torch.matmul(dl, k.float()) * scale
    dk = torch.matmul(dl.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), g32)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _bwd_max_chunks(device: torch.device, bn: int, lq: int, lk: int, hd: int) -> int:
    """Query chunks of B8's dk/dv pass: about two blocks per SM (blocks are
    64 keys x a chunk x batch·head, x2 where hd 128/192 halves the head dim),
    at least four 64-row query tiles per chunk."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = -(-lk // 64) * (2 if hd in (128, 192) else 1) * bn
    return max(1, min(-(-lq // 64) // 4, -(-2 * sms // blocks)))


def fused_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
    scale: float, lse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax(q kᵀ · scale) v for the output gradient g.

    q, out, g: (B, N, Lq, hd); k, v: (B, N, Lk, hd), any strides with unit
    columns; lse: K1's fp32 (B·N, Lq) log-sum-exp rows, required on CUDA.
    dq is a view of a token-major (B, Lq, N·hd) buffer, dk and dv are
    contiguous, all in q's dtype.
    """
    if q.device.type == "cpu":
        return fused_attention_bwd_plain(q, k, v, out, g, scale, lse)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bwd: unsupported device {q.device}")
    _build.check_cuda_inputs("fused_attention_bwd", q, k, v, out, g)
    _check_shapes("fused_attention_bwd", q, k, v)
    b, n, lq, hd = q.shape
    lk = k.shape[2]
    if out.shape != q.shape or g.shape != q.shape:
        raise ValueError(f"fused_attention_bwd: out {tuple(out.shape)} / g {tuple(g.shape)} "
                         f"are not q's {tuple(q.shape)}")
    if (lse is None or lse.shape != (b * n, lq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError("fused_attention_bwd: needs K1's fp32 (B·N, Lq) log-sum-exp rows "
                         "on q's device")
    q, k, v, out, g = (_rows16(t) for t in (q, k, v, out, g))
    lse = lse.contiguous()
    dev, dt = q.device, q.dtype
    delta = torch.empty((b * n, lq), dtype=torch.float32, device=dev)
    dq = torch.empty((b, lq, n, hd), dtype=dt, device=dev)
    dk = torch.empty((b, n, lk, hd), dtype=dt, device=dev)
    dv = torch.empty_like(dk)
    chunks = _bwd_max_chunks(dev, b * n, lq, lk, hd)
    ws = (torch.empty((chunks, 2, b * n, lk, hd), dtype=torch.float32, device=dev)
          if chunks > 1 else None)
    fn = _build.function("attention_bwd", "csts_attention_bwd")
    err = fn(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), ws.data_ptr() if ws is not None else None, chunks,
        b, n, lq, lk, hd,
        *(s for t in (q, k, v, out, g) for s in (t.stride(0), t.stride(1), t.stride(2))),
        lq * n * hd, hd, n * hd,
        float(scale), _build.stream_ptr(q),
    )
    _build.check_launch("fused_attention_bwd", err)
    fused_attention_bwd.launches += 1
    return dq.permute(0, 2, 1, 3), dk, dv


fused_attention_bwd.launches = 0


def masked_attention_bwd_plain(q, k, v, mask, g, scale):
    """The masked sites' backward, JAX's XLA fallback (``_bwd`` at
    ``attention.py:361-375``) in plain PyTorch: fp32 probabilities recomputed
    from q, k and the mask, delta = rowsum(dP·p), fp32 products, one rounding
    of each gradient. The mask is a buffer and gets none."""
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
                      + mask.float(), dim=-1)
    g32 = g.float()
    dv = torch.matmul(p.transpose(-1, -2), g32)
    dp = torch.matmul(g32, v.float().transpose(-1, -2))
    dl = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(dl, k.float()) * scale
    dk = torch.matmul(dl.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FusedAttention(torch.autograd.Function):
    """K1 forward; B8 backward where there is no mask, the plain recompute
    where there is one. The same code on both devices: on the CPU the
    wrappers run their plain twins."""

    @staticmethod
    def forward(ctx, q, k, v, scale, mask):
        ctx.scale = float(scale)
        if q.device.type == "cuda":
            out, lse = _attention_fwd(q, k, v, scale, mask, with_lse=mask is None)
        else:
            out, lse = fused_attention(q, k, v, scale, mask), None
        if mask is None:
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            ctx.save_for_backward(q, k, v, mask)
        ctx.masked = mask is not None
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.masked:
            q, k, v, mask = ctx.saved_tensors
            dq, dk, dv = masked_attention_bwd_plain(q, k, v, mask, g, ctx.scale)
        else:
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = fused_attention_bwd(q, k, v, out, g, ctx.scale, lse)
        return dq, dk, dv, None, None


def attention_train(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`fused_attention` inside autograd (see :class:`FusedAttention`)."""
    return FusedAttention.apply(q, k, v, scale, mask)

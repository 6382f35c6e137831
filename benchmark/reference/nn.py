"""Plain PyTorch pieces of the reference models: every product and
convolution goes through ``F`` with its operands passed through ``rd``, the
rounding of the precision the reference runs in (:mod:`.lowp`; the identity
in fp32). Tokens are channels-last ``(B, L, C)`` beside their ``(T, H, W)``
grid; weights are in PyTorch's ``nn.Linear`` / ``nn.Conv3d`` layout under the
published models' parameter names.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .arch import THW, Block

Params = Dict[str, torch.Tensor]
Round = Callable[[torch.Tensor], torch.Tensor]


def ident(x: torch.Tensor) -> torch.Tensor:
    return x


def linear(x, w, b, rd: Round = ident):
    return F.linear(rd(x), rd(w), b)


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def conv3d(x, w, b, stride, padding, rd: Round = ident):
    """(B, T, H, W, C_in) -> (B, T', H', W', C_out)."""
    out = F.conv3d(rd(x).permute(0, 4, 1, 2, 3), rd(w), b, stride, padding)
    return out.permute(0, 2, 3, 4, 1)


def pool_heads(x, w, nw, nb, thw, stride, padding, groups, rd: Round, has_cls: bool,
               upsample: bool = False, output_padding=(0, 0, 0)):
    """Per-head depthwise (transposed) conv of (B, N, L, hd) tokens on grid
    ``thw``, then the pool norm (eps 1e-5). A cls token bypasses the conv."""
    cls = None
    if has_cls:
        cls, x = x[:, :, :1], x[:, :, 1:]
    b, n, _, hd = x.shape
    grid = x.transpose(2, 3).reshape(b * n, hd, *thw)
    if upsample:
        out = F.conv_transpose3d(rd(grid), rd(w), None, stride, padding, output_padding, groups)
    else:
        out = F.conv3d(rd(grid), rd(w), None, stride, padding, 1, groups)
    new = tuple(out.shape[2:])
    out = out.reshape(b, n, hd, -1).transpose(2, 3)
    if cls is not None:
        out = torch.cat([cls, out], dim=2)
    return layer_norm(out, nw, nb, 1e-5), new


def attention(q, k, v, scale: float, mask: Optional[torch.Tensor], rd: Round):
    """softmax(q kᵀ · scale + mask) v over (B, N, L, hd)."""
    logits = torch.matmul(rd(q), rd(k).transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask
    return torch.matmul(rd(torch.softmax(logits, dim=-1)), rd(v))


def block(P: Params, pre: str, blk: Block, x: torch.Tensor, thw: THW,
          mask: Optional[torch.Tensor] = None,
          drop: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          rd: Round = ident) -> Tuple[torch.Tensor, THW]:
    """One multiscale block (``slowfast/models/attention.py``
    ``MultiScaleBlock``): LN1 → qkv → pooled (or upsampled) Q, pooled K/V,
    each with its norm → attention → proj; the skip of the unnormed input
    (MaxPool3d at a Q pool, trilinear upsample at a Q upsample, else the
    identity) plus the attention branch; LN2 → fc1 → GELU → fc2 added to
    that sum, or to proj(LN2(x)) where the width changes. ``drop``: the
    stochastic-depth factors (B,) of the attention and MLP branches."""
    b, l, _ = x.shape
    n, hd = blk.heads, blk.head_dim
    xn = layer_norm(x, P[pre + "norm1.weight"], P[pre + "norm1.bias"], 1e-6)
    qkv = linear(xn, P[pre + "attn.qkv.weight"], P.get(pre + "attn.qkv.bias"), rd)
    q, k, v = qkv.reshape(b, l, 3, n, hd).permute(2, 0, 3, 1, 4)
    a = pre + "attn."
    thw_q = thw
    if blk.pool_q:
        pad = tuple(i // 2 for i in blk.kernel_q)
        if blk.upsample_q:
            q, thw_q = pool_heads(q, P[a + "upsample_q.weight"], P[a + "norm_q.weight"],
                                  P[a + "norm_q.bias"], thw, blk.stride_q, pad, hd, rd, False,
                                  True, tuple(s - 1 for s in blk.stride_q))
        else:
            q, thw_q = pool_heads(q, P[a + "pool_q.weight"], P[a + "norm_q.weight"],
                                  P[a + "norm_q.bias"], thw, blk.stride_q, pad, hd, rd,
                                  blk.has_cls)
    if blk.pool_kv:
        pad = tuple(i // 2 for i in blk.kernel_kv)
        k, _ = pool_heads(k, P[a + "pool_k.weight"], P[a + "norm_k.weight"],
                          P[a + "norm_k.bias"], thw, blk.stride_kv, pad, hd, rd, blk.has_cls)
        v, _ = pool_heads(v, P[a + "pool_v.weight"], P[a + "norm_v.weight"],
                          P[a + "norm_v.bias"], thw, blk.stride_kv, pad, hd, rd, blk.has_cls)
    out = attention(q, k, v, hd ** -0.5, mask, rd)
    out = out.transpose(1, 2).reshape(b, out.shape[2], n * hd)
    out = linear(out, P[a + "proj.weight"], P[a + "proj.bias"], rd)
    if drop is not None:
        out = out * drop[0][:, None, None]
    skip = x
    if blk.upsample_q and tuple(blk.stride_q) != (1, 1, 1):
        size = tuple(d * s for d, s in zip(thw, blk.stride_q))
        grid = x.reshape(b, *thw, -1).permute(0, 4, 1, 2, 3)
        skip = F.interpolate(grid, size=size, mode="trilinear", align_corners=False)
        skip = skip.permute(0, 2, 3, 4, 1).reshape(b, -1, x.shape[-1])
    elif not blk.upsample_q and blk.stride_q:
        kern = tuple(s + 1 if s > 1 else s for s in blk.stride_q)
        cls = None
        if blk.has_cls:
            cls, skip = skip[:, :1], skip[:, 1:]
        grid = skip.reshape(b, *thw, -1).permute(0, 4, 1, 2, 3)
        grid = F.max_pool3d(grid, kern, blk.stride_q, tuple(i // 2 for i in kern))
        skip = grid.permute(0, 2, 3, 4, 1).reshape(b, -1, x.shape[-1])
        if cls is not None:
            skip = torch.cat([cls, skip], dim=1)
    x = skip + out
    xn2 = layer_norm(x, P[pre + "norm2.weight"], P[pre + "norm2.bias"], 1e-6)
    hid = F.gelu(linear(xn2, P[pre + "mlp.fc1.weight"], P[pre + "mlp.fc1.bias"], rd))
    mlp = linear(hid, P[pre + "mlp.fc2.weight"], P[pre + "mlp.fc2.bias"], rd)
    if drop is not None:
        mlp = mlp * drop[1][:, None, None]
    if blk.dim != blk.dim_out:
        x = linear(xn2, P[pre + "proj.weight"], P[pre + "proj.bias"], rd)
    return x + mlp, thw_q


def norm_params(name: str, d: int) -> Dict[str, tuple]:
    """A LayerNorm's gain and shift, drawn around 1 and 0 (never constant)."""
    return {name + ".weight": ((d,), "gain"), name + ".bias": ((d,), "shift")}


def linear_params(name: str, c_out: int, c_in: int) -> Dict[str, tuple]:
    """``nn.Linear``'s own initialisation: weight and bias U(±1/sqrt(fan_in))."""
    bound = ("uniform", 1.0 / c_in ** 0.5)
    return {name + ".weight": ((c_out, c_in), bound), name + ".bias": ((c_out,), bound)}


def block_params(pre: str, blk: Block) -> Dict[str, tuple]:
    """{name: (shape, init)} of one block. init: "tn" (truncated normal,
    std 0.02), "gain" (1 + std 0.1), "shift" (std 0.1), or ("uniform", bound)."""
    d, hd, h = blk.dim, blk.head_dim, blk.hidden
    out = norm_params(pre + "norm1", d)
    out.update(linear_params(pre + "attn.qkv", 3 * d, d))
    if not blk.qkv_bias:
        del out[pre + "attn.qkv.bias"]
    out.update(linear_params(pre + "attn.proj", d, d))
    k27 = ("uniform", 1.0 / 27 ** 0.5)
    if blk.pool_q:
        name = "upsample_q" if blk.upsample_q else "pool_q"
        out[pre + f"attn.{name}.weight"] = ((hd, 1, *blk.kernel_q), k27)
        out.update(norm_params(pre + "attn.norm_q", hd))
    if blk.pool_kv:
        for kv in ("k", "v"):
            out[pre + f"attn.pool_{kv}.weight"] = ((hd, 1, *blk.kernel_kv), k27)
            out.update(norm_params(pre + f"attn.norm_{kv}", hd))
    out.update(norm_params(pre + "norm2", d))
    out.update(linear_params(pre + "mlp.fc1", h, d))
    out.update(linear_params(pre + "mlp.fc2", blk.dim_out, h))
    if blk.dim != blk.dim_out:
        out.update(linear_params(pre + "proj", blk.dim_out, d))
    return out


def conv_params(name: str, c_out: int, c_in: int, kernel) -> Dict[str, tuple]:
    bound = ("uniform", 1.0 / (c_in * kernel[0] * kernel[1] * kernel[2]) ** 0.5)
    return {name + ".weight": ((c_out, c_in, *kernel), bound), name + ".bias": ((c_out,), bound)}

"""Multiscale Vision Transformer blocks (``csts_tpu/models/mvit.py``).

Tokens are channels-last ``(B, L, C)`` with the static ``(T, H, W)`` grid
carried beside them, as in the JAX package. Module and parameter names follow
the reference PyTorch model (``slowfast/models/attention.py``), so the
released ``.pyth`` weights and :func:`csts_torch.convert.from_jax.state_dict_from_jax`
load with ``strict=True``.

Every block runs LN1 → qkv → pooling convs → attention core (K1) → proj →
skip → MLP tail (K2); the decoder's stride-(2,1,1) skip is K3. The kernels
are called through their modules (``ka.fused_attention`` ...) so a check can
swap in the plain versions on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from csts_torch import ops
from csts_torch.kernels import attention as ka
from csts_torch.kernels import block as kb
from csts_torch.kernels import upsample as kup

THW = Tuple[int, int, int]


def round_width(width: int, multiplier: float, min_width: int = 1, divisor: int = 1) -> int:
    """Channel rounding rule (slowfast/models/utils.py:9-24)."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    width_out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if width_out < 0.9 * width:
        width_out += divisor
    return int(width_out)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Static metadata for one attention block (field for field the JAX one)."""

    dim: int
    dim_out: int
    num_heads: int
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path: float = 0.0
    # () means "no pool op on that path" (attention.py:94-97 skip rule)
    kernel_q: Tuple[int, ...] = ()
    kernel_kv: Tuple[int, ...] = ()
    stride_q: Tuple[int, ...] = ()
    stride_kv: Tuple[int, ...] = ()
    mode: str = "conv"
    # decoder blocks upsample Q with ConvTranspose3d instead of pooling
    upsample_q: bool = False
    # the JAX package's switch for its Pallas attention; kept so the specs of
    # the two packages compare equal (the port always runs its kernels on CUDA)
    fused: bool = False
    has_cls: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def scale(self) -> float:
        return self.head_dim ** -0.5

    @property
    def pool_q_on(self) -> bool:
        if not self.kernel_q:
            return False
        return not (_prod(self.kernel_q) == 1 and _prod(self.stride_q) == 1)

    @property
    def pool_kv_on(self) -> bool:
        if not self.kernel_kv:
            return False
        return not (_prod(self.kernel_kv) == 1 and _prod(self.stride_kv) == 1)

    @property
    def padding_q(self) -> Tuple[int, ...]:
        return tuple(int(k // 2) for k in self.kernel_q)

    @property
    def padding_kv(self) -> Tuple[int, ...]:
        return tuple(int(k // 2) for k in self.kernel_kv)

    @property
    def output_padding_q(self) -> Tuple[int, ...]:
        # attention.py:323 — outpadding = stride-1 where stride>1
        return tuple(0 if s == 1 else s - 1 for s in self.stride_q)

    @property
    def skip_kernel(self) -> Tuple[int, ...]:
        # attention.py:193 — kernel_skip = [s+1 if s>1 else s for s in stride_q]
        return tuple(s + 1 if s > 1 else s for s in self.stride_q)

    @property
    def skip_pool_on(self) -> bool:
        return len(self.skip_kernel) > 0

    @property
    def skip_upsample_on(self) -> bool:
        # attention.py:463-467 — trilinear upsample unless all strides are 1
        return bool(self.stride_q) and sum(self.stride_q) != len(self.stride_q)

    @property
    def hidden_dim(self) -> int:
        # the decoder blocks size their MLP from dim_out (attention.py:433)
        return int((self.dim_out if self.upsample_q else self.dim) * self.mlp_ratio)


# ----------------------------------------------------------------------------------
# pooling / upsampling of per-head tokens
# ----------------------------------------------------------------------------------


def _pool_heads(
    x: torch.Tensor,
    conv: nn.Module,
    norm: nn.LayerNorm,
    thw: THW,
    stride,
    padding,
    transposed: bool = False,
    output_padding=(0, 0, 0),
) -> Tuple[torch.Tensor, THW]:
    """Per-head depthwise (transposed) conv over (B·N, T, H, W, hd) and the
    pool norm at eps 1e-5 (attention.py:11-49 attention_pool and :251-289
    attention_upsample; the reference hard-codes torch's default eps there)."""
    b, n, l, hd = x.shape
    # one copy of the head views into NCDHW memory, read through a
    # channels-last view (the convs' layout) without another
    grid = x.transpose(2, 3).reshape(b * n, hd, *thw).permute(0, 2, 3, 4, 1)
    if transposed:
        out = ops.depthwise_conv_transpose3d(grid, conv.weight, stride, padding, output_padding)
    else:
        out = ops.depthwise_conv3d(grid, conv.weight, stride, padding)
    new_thw = tuple(int(s) for s in out.shape[1:4])
    out = out.reshape(b, n, -1, hd)
    return ops.layer_norm(out, norm.weight, norm.bias, eps=1e-5), new_thw


def pool_tokens_max(x: torch.Tensor, thw: THW, kernel, stride, padding) -> Tuple[torch.Tensor, THW]:
    """MaxPool3d on (B, L, C) tokens — the encoder's residual skip (attention.py:234-241)."""
    b, l, c = x.shape
    pooled = ops.max_pool3d(x.reshape(b, *thw, c), kernel, stride, padding)
    new_thw = tuple(int(s) for s in pooled.shape[1:4])
    return pooled.reshape(b, -1, c), new_thw


def upsample_tokens_trilinear(x: torch.Tensor, thw: THW, stride) -> Tuple[torch.Tensor, THW]:
    """nn.Upsample(scale_factor=stride, trilinear) on tokens (attention.py:463-467).
    The stride-(2,1,1) case is K3; the others go to the plain resize op."""
    b, l, c = x.shape
    t, h, w = thw
    size = (t * stride[0], h * stride[1], w * stride[2])
    if tuple(stride) == (2, 1, 1):
        return kup.t2_upsample(x, thw), size
    up = ops.trilinear_resize(x.reshape(b, t, h, w, c), size)
    return up.reshape(b, -1, c), size


# ----------------------------------------------------------------------------------
# MultiScaleAttention / MultiScaleBlock (attention.py:52-248, 292-479)
# ----------------------------------------------------------------------------------


class MultiScaleAttention(nn.Module):
    def __init__(self, spec: AttentionSpec):
        super().__init__()
        assert spec.mode == "conv", "only 'conv' pooling mode is exercised by CSTS"
        assert not spec.has_cls, "CSTS runs without a cls token"
        self.spec = spec
        hd = spec.head_dim
        self.qkv = nn.Linear(spec.dim, 3 * spec.dim, bias=spec.qkv_bias)
        self.proj = nn.Linear(spec.dim, spec.dim)
        if spec.pool_q_on:
            if spec.upsample_q:
                self.upsample_q = nn.ConvTranspose3d(
                    hd, hd, spec.kernel_q, spec.stride_q, spec.padding_q,
                    spec.output_padding_q, groups=hd, bias=False)
            else:
                self.pool_q = nn.Conv3d(
                    hd, hd, spec.kernel_q, spec.stride_q, spec.padding_q, groups=hd, bias=False)
            self.norm_q = nn.LayerNorm(hd, eps=1e-5)
        if spec.pool_kv_on:
            for name in ("k", "v"):
                setattr(self, f"pool_{name}", nn.Conv3d(
                    hd, hd, spec.kernel_kv, spec.stride_kv, spec.padding_kv, groups=hd, bias=False))
                setattr(self, f"norm_{name}", nn.LayerNorm(hd, eps=1e-5))

    def forward(
        self, xn: torch.Tensor, thw: THW, mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, THW]:
        """xn: LN1'd tokens (B, L, dim). Returns (out (B, Lq, dim), thw_q)."""
        s = self.spec
        b, l, _ = xn.shape
        qkv = ops.linear(xn, self.qkv.weight, self.qkv.bias)
        qkv = qkv.reshape(b, l, 3, s.num_heads, s.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, N, L, hd) head views
        q_thw = thw
        if s.pool_q_on:
            if s.upsample_q:
                q, q_thw = _pool_heads(q, self.upsample_q, self.norm_q, thw, s.stride_q,
                                       s.padding_q, transposed=True,
                                       output_padding=s.output_padding_q)
            else:
                q, q_thw = _pool_heads(q, self.pool_q, self.norm_q, thw, s.stride_q, s.padding_q)
        if s.pool_kv_on:
            k, _ = _pool_heads(k, self.pool_k, self.norm_k, thw, s.stride_kv, s.padding_kv)
            v, _ = _pool_heads(v, self.pool_v, self.norm_v, thw, s.stride_kv, s.padding_kv)
        out = ka.fused_attention(q, k, v, s.scale, mask)
        out = out.transpose(1, 2).reshape(b, out.shape[2], s.dim)
        return ops.linear(out, self.proj.weight, self.proj.bias), q_thw


class Mlp(nn.Module):
    def __init__(self, dim_in: int, hidden: int, dim_out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim_in, hidden)
        self.fc2 = nn.Linear(hidden, dim_out)


class MultiScaleBlock(nn.Module):
    """Pre-LN attention + residual (pooled / upsampled skip) + MLP tail.

    Reference quirks replicated exactly:
    * the residual skip is MaxPool3d (encoder) or trilinear upsample (decoder)
      of the *unnormed* input;
    * when dim != dim_out the second residual is ``proj(norm2(x))``
      (attention.py:243-247) — K2's base;
    * fusion blocks pass stride_q=() so both skip transforms are identity.
    Inference only: stochastic depth is the identity at eval.
    """

    def __init__(self, spec: AttentionSpec):
        super().__init__()
        self.spec = spec
        self.norm1 = nn.LayerNorm(spec.dim, eps=1e-6)
        self.attn = MultiScaleAttention(spec)
        self.norm2 = nn.LayerNorm(spec.dim, eps=1e-6)
        self.mlp = Mlp(spec.dim, spec.hidden_dim, spec.dim_out)
        if spec.dim != spec.dim_out:
            self.proj = nn.Linear(spec.dim, spec.dim_out)

    def forward(
        self, x: torch.Tensor, thw: THW, mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, THW]:
        s = self.spec
        xn = ops.layer_norm(x, self.norm1.weight, self.norm1.bias)
        x_block, thw_new = self.attn(xn, thw, mask)
        if s.upsample_q:
            x_res = upsample_tokens_trilinear(x, thw, s.stride_q)[0] if s.skip_upsample_on else x
        elif s.skip_pool_on:
            pad = tuple(int(k // 2) for k in s.skip_kernel)
            x_res, _ = pool_tokens_max(x, thw, s.skip_kernel, s.stride_q, pad)
        else:
            x_res = x
        x = x_res + x_block
        proj = getattr(self, "proj", None)
        x = kb.fused_mlp_tail(
            x, self.norm2.weight, self.norm2.bias,
            self.mlp.fc1.weight, self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias,
            proj.weight if proj is not None else None, proj.bias if proj is not None else None,
        )
        return x, thw_new


def build_inframe_mask(thw: THW, num_audio_tokens: int) -> np.ndarray:
    """Additive fp32 mask (L, L) of the spatial fusion: 0 where attention is
    allowed, -1e8 elsewhere (av_attention.py:336-346).

    Token layout: [T·H·W video tokens frame-major, then T audio tokens]. A video
    token of frame t attends to frame t's video tokens and audio token t; audio
    token t attends to frame t's video tokens and itself.
    """
    t, h, w = thw
    assert num_audio_tokens == t
    hw = h * w
    total = t * hw + t
    mask = np.full((total, total), -1e8, dtype=np.float32)
    for f in range(t):
        sl = slice(hw * f, hw * (f + 1))
        mask[sl, sl] = 0.0
        mask[sl, t * hw + f] = 0.0
        mask[t * hw + f, sl] = 0.0
        mask[t * hw + f, t * hw + f] = 0.0
    return mask

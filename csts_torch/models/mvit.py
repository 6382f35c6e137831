"""Multiscale Vision Transformer blocks (``csts_tpu/models/mvit.py``).

Tokens are channels-last ``(B, L, C)`` with the static ``(T, H, W)`` grid
carried beside them, as in the JAX package. Module and parameter names follow
the reference PyTorch model (``slowfast/models/attention.py``), so the
released ``.pyth`` weights and :func:`csts_torch.convert.from_jax.state_dict_from_jax`
load with ``strict=True``.

At eval a block dispatches as the JAX package's ``multiscale_block_apply``
does (``csts_tpu/models/mvit.py:640-703``): an identity-skip block with at
most two heads runs whole in B3 (``kb.fused_block``), an upsample-Q decoder
block in B5 (``kb.fused_decoder_block``), a Q-pool block in B4
(``kb.fused_pool_block``); every other block runs LN1 → qkv → pooling convs →
attention core (K1) → proj → skip → MLP tail (K2). The decoder's
stride-(2,1,1) skip is K3; its stride-(1,2,2) skips on B5's route are B9a
(``kup.hw2_upsample``) when the JAX package's switch
``kup.HW2_SKIP_KERNEL`` is set (off by default, as in JAX). In training (``module.train()``) every block takes
the composite route, as the JAX predicates force when not deterministic: K1
forward with B8 backward (``ka.attention_train``), the skip plus the
stochastic-depth attention branch, and the B7 tail (``kb.mlp_tail_train``)
with the MLP branch's mask as its per-sample factor; K3 through
``kup.t2_upsample_train``. A block asked for its attention map
(``return_attn``: the fusion blocks' maps) takes the composite route with
the plain attention core and its fp32 probabilities (:func:`attention_probs`,
JAX's ``_attention_core`` with ``need_attn``) in place of K1, at eval and in
training, as JAX's predicates leave every whole-block route then. The
kernels are called through their modules (``ka.fused_attention`` ...) so a
check can swap in the plain versions on the card. The dispatch depends on
the model and its mode only, never on the device. A block of the MViT
classifier (``has_cls``) pools with its leading cls token bypassing the
pools (JAX's ``pool_heads_conv`` and ``pool_tokens_max``) and takes K1+K2:
B3 and B4 refuse the token, as JAX's predicates do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from csts_torch import ops
from csts_torch.parallel import mesh
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
    has_cls: bool = False,
) -> Tuple[torch.Tensor, THW]:
    """Per-head depthwise (transposed) conv over (B·N, T, H, W, hd) and the
    pool norm at eps 1e-5 (attention.py:11-49 attention_pool and :251-289
    attention_upsample; the reference hard-codes torch's default eps there).
    With ``has_cls`` the leading token bypasses the pool and is prepended
    again before the norm (attention.py:24-43; ``csts_tpu/models/mvit.py``
    ``pool_heads_conv``)."""
    cls_tok = None
    if has_cls:
        cls_tok, x = x[:, :, :1], x[:, :, 1:]
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
    if cls_tok is not None:
        out = torch.cat([cls_tok, out], dim=2)
    return ops.layer_norm(out, norm.weight, norm.bias, eps=1e-5), new_thw


def pool_tokens_max(x: torch.Tensor, thw: THW, kernel, stride, padding,
                    has_cls: bool = False) -> Tuple[torch.Tensor, THW]:
    """MaxPool3d on (B, L, C) tokens — the encoder's residual skip
    (attention.py:234-241); with ``has_cls`` the leading token bypasses the
    pool and leads the output."""
    cls_tok = None
    if has_cls:
        cls_tok, x = x[:, :1], x[:, 1:]
    b, l, c = x.shape
    pooled = ops.max_pool3d(x.reshape(b, *thw, c), kernel, stride, padding)
    new_thw = tuple(int(s) for s in pooled.shape[1:4])
    pooled = pooled.reshape(b, -1, c)
    if cls_tok is not None:
        pooled = torch.cat([cls_tok, pooled], dim=1)
    return pooled, new_thw


def upsample_tokens_trilinear(x: torch.Tensor, thw: THW, stride, train: bool = False,
                              decoder_kernel: bool = False) -> Tuple[torch.Tensor, THW]:
    """nn.Upsample(scale_factor=stride, trilinear) on tokens (attention.py:463-467).
    The stride-(2,1,1) case is K3 (inside autograd when ``train``) while
    ``kup.T2_SKIP_KERNEL`` is set. The
    stride-(1,2,2) case is B9a when ``kup.HW2_SKIP_KERNEL`` is set, at eval,
    for the skip of a block on B5's route (``decoder_kernel``): the JAX
    package reads the switch there only (``_decoder_kernel_forward``,
    ``csts_tpu/models/mvit.py:798``). The others go to the plain resize op."""
    b, l, c = x.shape
    t, h, w = thw
    size = (t * stride[0], h * stride[1], w * stride[2])
    if tuple(stride) == (2, 1, 1) and kup.T2_SKIP_KERNEL:
        return (kup.t2_upsample_train if train else kup.t2_upsample)(x, thw), size
    if tuple(stride) == (1, 2, 2) and decoder_kernel and kup.HW2_SKIP_KERNEL and not train:
        return kup.hw2_upsample(x, thw), size
    up = ops.trilinear_resize(x.reshape(b, t, h, w, c), size)
    return up.reshape(b, -1, c), size


# ----------------------------------------------------------------------------------
# which blocks run whole in B3, B4 or B5 (csts_tpu/kernels/block.py predicates)
# ----------------------------------------------------------------------------------


def _static_pool_out(thw: THW, kernel, stride, padding) -> THW:
    return tuple(
        (d + 2 * p - k) // s + 1 for d, k, s, p in zip(thw, kernel, stride, padding)
    )


def _static_upsample_out(thw: THW, kernel, stride, padding, output_padding) -> THW:
    return tuple(
        (d - 1) * s - 2 * p + k + op
        for d, k, s, p, op in zip(thw, kernel, stride, padding, output_padding)
    )


def _lk(spec: AttentionSpec, thw: THW) -> int:
    """Pooled K/V length of a block on grid ``thw``."""
    if not spec.pool_kv_on:
        return _prod(thw)
    return _prod(_static_pool_out(thw, spec.kernel_kv, spec.stride_kv, spec.padding_kv))


def _fc_bytes(spec: AttentionSpec) -> int:
    # the JAX kernels keep the fc weights resident and cap them at 8 MiB in
    # bf16 (block.py:1042, :1413); the cap keeps the dim-768 blocks on K1+K2
    return (spec.dim * spec.hidden_dim + spec.hidden_dim * spec.dim_out) * 2


def _kernel_widths(spec: AttentionSpec) -> bool:
    """The widths the whole-block kernels B3-B5 are built for: dim, dim_out,
    the hidden width and the head dim multiples of 16 (their products take
    16 columns a step and their loads 16-byte pieces of a row). The JAX
    predicates (``kb.eligible``, ``kb.pool_block_eligible``,
    ``kb.decoder_eligible``) pad to 128 lanes instead and have no such
    guard: a block of other widths takes the K1+K2 route here, which takes
    every width (K1 pads its head dim, K2 its widths), so the route differs
    from JAX's and the result does not."""
    return all(w % 16 == 0 for w in (spec.dim, spec.dim_out, spec.hidden_dim, spec.head_dim))


# --- which compiled instance a whole-block launch picks, and whether it fits --
# A mirror of csrc/fused_block.cuh (Plan::smem_bytes, pick_shape,
# launch_widest, launch_mma's checks) and of the CSTS_FB_CASE lists and
# split instances of block.cu, pool_block.cu and decoder_block.cu, so that a
# width whose instance does not fit a block's shared memory is routed to
# K1+K2 before any launch.

_SMEM_MAX = 232448  # bytes of shared memory a block may take (common.cuh kMaxSmem)
# the first design's (WR, NTP, NT, HDM) instances of each library
_FB_CASES = {
    "block": ((2, 3, 6, 128), (2, 3, 3, 128), (2, 6, 12, 128), (2, 6, 6, 128),
              (2, 12, 12, 128), (1, 12, 12, 128), (2, 6, 12, 256)),
    "pool_block": ((2, 6, 6, 128), (2, 6, 12, 128), (2, 12, 12, 128), (2, 3, 6, 128)),
    "decoder_block": ((1, 12, 6, 256), (2, 12, 6, 128), (2, 6, 3, 128), (1, 12, 6, 128)),
}
_FB_HD256 = {"block": True, "pool_block": False, "decoder_block": True}  # launch_widest's HD256


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def _pick_nt(cols: int, wc: int) -> int:
    need = -(-cols // (8 * wc))
    return 3 if need <= 3 else 6 if need <= 6 else 12 if need <= 12 else 0


def _fb_smem(wr: int, ntp: int, nt: int, c: int, hd: int) -> int:
    """Plan<WR, NTP, NT>::smem_bytes(C, hd) of ``fused_block.cuh``."""
    kw = lambda rows: 128 if rows <= 192 else 64 if rows <= 384 else 32  # noqa: E731 tile_kw
    bm, wc, rw = 32 * wr, 8 // wr, 2 * wr
    bn, bnp = wc * 8 * nt, wc * 8 * ntp
    tile = max(128 * (128 + 8), bn * (kw(bn) + 8), bnp * (kw(bnp) + 8))
    region = max(2 * _align128(2 * tile), 4 * _align128(2 * 64 * (hd + 8)),
                 4 * rw * (8 // rw - 1) * (16 * hd + 32), 4 * bm * (c + 4))
    return 2 * _align128(2 * bm * (c + 8)) + _align128(2 * bm * (128 + 8)) + _align128(region)


def _split_instance(lib: str, spec: AttentionSpec) -> bool:
    """The redesigned split bodies' instances (``kb.split_instance``), which
    fit by construction."""
    return kb.split_instance(lib, spec.dim, spec.dim_out, spec.hidden_dim, spec.head_dim,
                             spec.dim != spec.dim_out)


def whole_block_fits(lib: str, spec: AttentionSpec) -> bool:
    """Whether the bf16 instance that library ``lib`` ("block",
    "pool_block", "decoder_block") would launch for this block holds it: a
    split instance, or the first design's instance (one of its listed
    shapes, else the widest of the row split) whose shared memory and Q-conv
    weight fit. A width that fails takes K1+K2 instead of a launch that would
    fail (at WR 1, head dims above 240 hold C ≤ 684 only)."""
    if _split_instance(lib, spec):
        return True
    c, cout, hd = spec.dim, spec.dim_out, spec.head_dim
    wr = 2 if c <= 384 else 1
    wc = 8 // wr
    shape = (wr, _pick_nt(c, wc), _pick_nt(min(cout, 96 * wc), wc), 128 if hd <= 128 else 256)
    if shape not in _FB_CASES[lib]:
        if shape[3] != 128 and not _FB_HD256[lib]:
            return False
        shape = (wr, 12, 12, shape[3])
        if c > wc * 8 * 12:  # wider than the widest instance's column tiles
            return False
    return _fb_smem(*shape[:3], c, hd) <= _SMEM_MAX and 27 * 4 * hd <= 2 * 32 * wr * (c + 8)


def block_eligible(spec: AttentionSpec, mask) -> bool:
    """B3 (``kb.eligible`` and the guards at ``mvit.py:640-646``): identity
    skip, at most two heads, no mask, no cls token. The JAX package's
    ``L % 128`` token-tile guard serves the TPU's tiling only and is dropped.
    Beyond JAX's predicate: dim ≤ 768 and head dim ≤ 256 (the largest the
    kernel's instances hold: a one-head block of dim 384 or a two-head one
    of 768 stays on K1+K2), :func:`_kernel_widths` and
    :func:`whole_block_fits`."""
    return (
        not spec.upsample_q
        and not spec.pool_q_on
        and not spec.skip_pool_on
        and not spec.has_cls
        and mask is None
        and spec.dim % spec.num_heads == 0
        and spec.num_heads <= 2
        and spec.dim <= 768
        and spec.head_dim <= 256
        and _kernel_widths(spec)
        and whole_block_fits("block", spec)
    )


def pool_block_eligible(spec: AttentionSpec, mask, thw: THW) -> bool:
    """B4 (``kb.pool_block_eligible``): stride (1,2,2), kernel 3, MaxPool
    (1,3,3) skip, head dim ≤ 128, Lk ≤ 1024, fc weights ≤ 8 MiB, no mask, no
    cls token. The row and 128-lane alignment of ``_pool_tile_plan`` is the
    TPU's tiling and is dropped; :func:`_kernel_widths` and
    :func:`whole_block_fits` are the port's own."""
    return (
        not spec.upsample_q
        and spec.pool_q_on
        and spec.skip_pool_on
        and not spec.has_cls
        and mask is None
        and tuple(spec.stride_q) == (1, 2, 2)
        and tuple(spec.kernel_q) == (3, 3, 3)
        and tuple(spec.skip_kernel) == (1, 3, 3)
        and spec.dim % spec.num_heads == 0
        and spec.head_dim <= 128
        and _fc_bytes(spec) <= 8 * 2 ** 20
        and _lk(spec, thw) <= 1024
        and _kernel_widths(spec)
        and whole_block_fits("pool_block", spec)
    )


def decoder_eligible(spec: AttentionSpec, mask, thw: THW) -> bool:
    """B5 (``kb.decoder_eligible``): an upsample-Q block with kernel 3,
    strides in {1, 2}, head dim ≤ 256, dim ≤ 768, Lk ≤ 512, fc weights ≤ 8
    MiB, no mask. ``_decoder_tile_plan``'s row and 128-lane alignment is the
    TPU's tiling and is dropped; :func:`_kernel_widths` and
    :func:`whole_block_fits` are the port's own."""
    return (
        spec.upsample_q
        and spec.pool_q_on
        and mask is None
        and spec.dim % spec.num_heads == 0
        and spec.head_dim <= 256
        and spec.dim <= 768
        and len(spec.stride_q) == 3
        and all(s in (1, 2) for s in spec.stride_q)
        and tuple(spec.kernel_q) == (3, 3, 3)
        and _fc_bytes(spec) <= 8 * 2 ** 20
        and _lk(spec, thw) <= 512
        and _kernel_widths(spec)
        and whole_block_fits("decoder_block", spec)
    )


def block_route(spec: AttentionSpec, mask, thw: THW, return_attn: bool = False) -> str:
    """The kernel a block runs in, in the JAX package's order:
    "block" (B3), "decoder_block" (B5), "pool_block" (B4) or "composite"
    (K1 and K2); a block asked for its attention map (``return_attn``)
    takes "attn_map": the composite route with the plain attention core
    (:func:`attention_probs`) in place of K1, as JAX's predicates leave
    every whole-block route then (``csts_tpu/models/mvit.py:643, :658,
    :687``)."""
    if return_attn:
        return "attn_map"
    if block_eligible(spec, mask):
        return "block"
    if decoder_eligible(spec, mask, thw):
        return "decoder_block"
    if pool_block_eligible(spec, mask, thw):
        return "pool_block"
    return "composite"


# ----------------------------------------------------------------------------------
# MultiScaleAttention / MultiScaleBlock (attention.py:52-248, 292-479)
# ----------------------------------------------------------------------------------


def attention_probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q kᵀ · scale [+ mask]) v with its probabilities, in plain
    PyTorch (JAX's ``_attention_core`` with ``need_attn``,
    ``csts_tpu/models/mvit.py:285-320``): fp32 logits from the inputs'
    dtype, fp32 probabilities, the product with v from the probabilities
    rounded to v's dtype, summed in fp32 and rounded once. Differentiable.
    q: (B, N, Lq, hd); k, v: (B, N, Lk, hd); mask: additive (Lq, Lk).
    Returns (out (B, N, Lq, hd) in v's dtype, probabilities (B, N, Lq, Lk)
    fp32)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    attn = torch.softmax(logits, dim=-1)
    out = torch.matmul(attn.to(v.dtype).float(), v.float()).to(v.dtype)
    return out, attn


class MultiScaleAttention(nn.Module):
    def __init__(self, spec: AttentionSpec):
        super().__init__()
        assert spec.mode == "conv", "only 'conv' pooling mode is exercised by CSTS"
        # the reference's upsample path has no cls token (attention.py:251-289)
        assert not (spec.has_cls and spec.upsample_q), "an upsample-Q block has no cls token"
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
        self.tp: Optional[Tuple[int, int]] = None  # (index, size) on the model axis once split

    def qkv_params(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """qkv's whole weight and bias: this module's, or under the model
        axis's split the ranks' heads gathered (for a route that runs the
        block whole; the backward keeps this rank's heads' gradient)."""
        if self.tp is None:
            return self.qkv.weight, self.qkv.bias
        s = self.spec

        def whole(t):
            heads = t.reshape(3, -1, s.head_dim, *t.shape[1:])
            return mesh.gather(heads, mesh.MODEL_AXIS, 1, partial=False).reshape(
                3 * s.dim, *t.shape[1:])

        return whole(self.qkv.weight), (None if self.qkv.bias is None else whole(self.qkv.bias))

    def proj_weight(self) -> torch.Tensor:
        """proj's whole weight (gathered by its input columns under the split)."""
        if self.tp is None:
            return self.proj.weight
        return mesh.gather(self.proj.weight, mesh.MODEL_AXIS, 1, partial=False)


    def project(self, xn: torch.Tensor, thw: THW, with_q: bool = True, local: bool = False):
        """xn: LN1'd tokens (B, L, dim) -> Q token-major (B, L, dim), a view of
        the projection (None unless ``with_q``), and K, V as (B, N, Lk, hd),
        pooled and normed where the block pools them (the whole-block kernels'
        phase 1, ``csts_tpu/models/mvit.py`` ``_pooled_kv`` and the Q
        projection of ``_slot_q_proj``, without the TPU's slot layouts).
        ``local``: this rank's heads of the model axis's split only (Q of
        width N/W · hd, K and V of N/W heads)."""
        s = self.spec
        b, l, _ = xn.shape
        w, bias = (self.qkv.weight, self.qkv.bias) if local else self.qkv_params()
        n = w.shape[0] // (3 * s.head_dim)
        c = n * s.head_dim
        lo = 0 if with_q else c
        proj = ops.linear(xn, w[lo:], bias[lo:] if bias is not None else None)
        kv = proj[..., -2 * c:].reshape(b, l, 2, n, s.head_dim)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        if s.pool_kv_on:
            k, _ = _pool_heads(k, self.pool_k, self.norm_k, thw, s.stride_kv, s.padding_kv,
                               has_cls=s.has_cls)
            v, _ = _pool_heads(v, self.pool_v, self.norm_v, thw, s.stride_kv, s.padding_kv,
                               has_cls=s.has_cls)
        return (proj[..., :c] if with_q else None), k, v

    def _pool_q(self, q: torch.Tensor, thw: THW) -> Tuple[torch.Tensor, THW]:
        s = self.spec
        if not s.pool_q_on:
            return q, thw
        if s.upsample_q:
            return _pool_heads(q, self.upsample_q, self.norm_q, thw, s.stride_q, s.padding_q,
                               transposed=True, output_padding=s.output_padding_q)
        return _pool_heads(q, self.pool_q, self.norm_q, thw, s.stride_q, s.padding_q,
                           has_cls=s.has_cls)

    def forward(
        self, xn: torch.Tensor, thw: THW, mask: Optional[torch.Tensor] = None,
        return_attn: bool = False, rows: Optional[Tuple[int, int]] = None,
    ):
        """xn: LN1'd tokens (B, L, dim). Returns (out (B, Lq, dim), thw_q),
        and with ``return_attn`` also the fp32 probabilities (B, N, Lq, Lk)
        from :func:`attention_probs`, which then replaces K1. ``rows``
        (first, count): the output rows of the seq axis's stripe only (Q's
        rows after its pool; K and V whole). Split on the model axis, the
        attention runs on this rank's heads and proj on their columns, summed
        over the axis (with ``return_attn``, the block runs whole)."""
        s = self.spec
        b, l, _ = xn.shape
        local = self.tp is not None and not return_attn
        if local:
            # the backward sums the heads' gradients of the normed tokens
            xn = mesh.copy_in(xn, mesh.MODEL_AXIS)
            # the pooling convs' and norms' weights are shared by the heads
            mesh.note_partial(mesh.MODEL_AXIS, mesh.module_params(
                self, ("pool_", "norm_", "upsample_q")))
        q, k, v = self.project(xn, thw, local=local)
        n = k.shape[1]
        q = q.reshape(b, l, n, s.head_dim).transpose(1, 2)  # (B, N, L, hd) view
        q, q_thw = self._pool_q(q, thw)
        if rows is not None:
            q = q[:, :, rows[0]:rows[0] + rows[1]]
        attn = None
        if return_attn:
            out, attn = attention_probs(q, k, v, s.scale, mask)
        else:
            attend = ka.attention_train if self.training else ka.fused_attention
            out = attend(q, k, v, s.scale, mask)
        out = out.transpose(1, 2).reshape(b, out.shape[2], n * s.head_dim)
        if local:
            out = mesh.reduce_sum(ops.linear(out, self.proj.weight), mesh.MODEL_AXIS)
            out = out + self.proj.bias.to(out.dtype)
        else:
            out = ops.linear(out, self.proj_weight(), self.proj.bias)
        return (out, q_thw, attn) if return_attn else (out, q_thw)


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
    Stochastic depth is the identity at eval; in training the caller passes
    the block's masks (``ops.sample_drop_masks``).
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
        self.tp: Optional[Tuple[int, int]] = None  # (index, size) on the model axis once split

    def can_split(self, w: int) -> bool:
        """Whether the model axis's ``w`` ranks split this block: its heads
        and its hidden width divide by ``w``."""
        s = self.spec
        return (w > 1 and not s.has_cls and s.num_heads % w == 0
                and s.hidden_dim % w == 0)

    @torch.no_grad()
    def split_heads(self, r: int, w: int) -> None:
        """Keeps rank ``r``'s part of the Megatron pairs (``parallel/mesh.py``
        ``split_model``): qkv's rows of heads [r·N/w, (r+1)·N/w) of each of
        Q, K and V, proj's input columns of those heads, fc1's rows and fc2's
        input columns of the r-th of w parts of the hidden width. The
        parameters are replaced by their shards, marked ``model_split``
        ("qkv" or the dimension split)."""
        s, a = self.spec, self.attn
        heads = slice(r * s.num_heads // w, (r + 1) * s.num_heads // w)
        cols = slice(r * s.dim // w, (r + 1) * s.dim // w)
        hid = slice(r * s.hidden_dim // w, (r + 1) * s.hidden_dim // w)

        def put(mod, name, value, how):
            p = nn.Parameter(value.contiguous().clone())
            p.model_split = how
            setattr(mod, name, p)

        put(a.qkv, "weight",
            a.qkv.weight.reshape(3, s.num_heads, s.head_dim, s.dim)[:, heads].reshape(-1, s.dim),
            "qkv")
        if a.qkv.bias is not None:
            put(a.qkv, "bias", a.qkv.bias.reshape(3, s.num_heads, s.head_dim)[:, heads].reshape(-1),
                "qkv")
        put(a.proj, "weight", a.proj.weight[:, cols], 1)
        put(self.mlp.fc1, "weight", self.mlp.fc1.weight[hid], 0)
        put(self.mlp.fc1, "bias", self.mlp.fc1.bias[hid], 0)
        put(self.mlp.fc2, "weight", self.mlp.fc2.weight[:, hid], 1)
        self.tp = a.tp = (r, w)

    def _tail_weights(self, dtype: Optional[torch.dtype] = None, attn_proj: bool = True) -> tuple:
        """wproj, bproj, then K2's weights: LN2, fc1, fc2 and the dim-change
        proj (None, None when dim == dim_out); cast to ``dtype`` if given.
        Under the model axis's split the shards are gathered whole (K2, B7
        and the whole blocks fuse across the split; the backward keeps this
        rank's part). ``attn_proj``: False leaves wproj and bproj None."""
        proj = getattr(self, "proj", None)
        fc1_w, fc1_b, fc2_w = self.mlp.fc1.weight, self.mlp.fc1.bias, self.mlp.fc2.weight
        if self.tp is not None:
            fc1_w = mesh.gather(fc1_w, mesh.MODEL_AXIS, 0, partial=False)
            fc1_b = mesh.gather(fc1_b, mesh.MODEL_AXIS, 0, partial=False)
            fc2_w = mesh.gather(fc2_w, mesh.MODEL_AXIS, 1, partial=False)
        ws = (
            self.attn.proj_weight() if attn_proj else None,
            self.attn.proj.bias if attn_proj else None, self.norm2.weight, self.norm2.bias,
            fc1_w, fc1_b, fc2_w, self.mlp.fc2.bias,
            proj.weight if proj is not None else None, proj.bias if proj is not None else None,
        )
        return ws if dtype is None else tuple(None if w is None else w.to(dtype) for w in ws)

    def forward(
        self, x: torch.Tensor, thw: THW, mask: Optional[torch.Tensor] = None,
        drop: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, return_attn: bool = False,
    ):
        """x: (B, L, dim) tokens on grid ``thw``. ``drop``: in training, the
        block's (attention-branch, MLP-branch) stochastic-depth masks, or None
        for none. Returns (out (B, L', dim_out), thw'), and with
        ``return_attn`` also the attention probabilities (B, N, L', Lk) fp32
        (:func:`block_route`'s "attn_map" route)."""
        if self.training:
            return self.forward_train(x, thw, mask, drop, return_attn)
        s, a = self.spec, self.attn
        route = block_route(s, mask, thw, return_attn)
        if route in ("composite", "attn_map"):
            return self.forward_composite(x, thw, mask, return_attn)
        if route == "block":
            return self.forward_block(x, thw)
        # the kernels take one dtype: fp32 master weights are cast to x's
        tail = self._tail_weights(x.dtype)
        xn = ops.layer_norm(x, self.norm1.weight, self.norm1.bias)
        q, k, v = a.project(xn, thw)
        if route == "decoder_block":
            thw_f = _static_upsample_out(thw, s.kernel_q, s.stride_q, s.padding_q,
                                         s.output_padding_q)
            out = kb.fused_decoder_block(q, thw, s.stride_q,
                                         self._skip(x, thw, decoder_kernel=True), k, v, s.scale,
                                         a.upsample_q.weight.to(x.dtype),
                                         a.norm_q.weight.to(x.dtype), a.norm_q.bias.to(x.dtype),
                                         *tail)
            return out, thw_f
        pad = tuple(int(kk // 2) for kk in s.skip_kernel)
        skip, thw_c = pool_tokens_max(x, thw, s.skip_kernel, s.stride_q, pad)
        out = kb.fused_pool_block(q, thw, skip, k, v, s.scale, a.pool_q.weight.to(x.dtype),
                                  a.norm_q.weight.to(x.dtype), a.norm_q.bias.to(x.dtype), *tail)
        return out, thw_c

    def forward_block(self, x: torch.Tensor, thw: THW) -> Tuple[torch.Tensor, THW]:
        """An identity-skip block whole in ``kb.fused_block`` after phase 1
        (LN1 and the pooled K/V): B3's route, which ``block_route`` gives the
        blocks of at most two heads. At 3-8 heads the same kernel stands for
        the JAX package's head-grid and block-diagonal variants, which it
        reaches only through ``fused_block(variant=...)``; so does the port,
        through ``csts_torch.tools.ab_block``."""
        s, a = self.spec, self.attn
        tail = self._tail_weights(x.dtype)
        xn = ops.layer_norm(x, self.norm1.weight, self.norm1.bias)
        _, k, v = a.project(xn, thw, with_q=False)
        wqkv, bqkv = a.qkv_params()
        bq = bqkv[:s.dim] if bqkv is not None else wqkv.new_zeros(s.dim)
        # xn, the rows phase 1 normalised, is also LN1 for the kernel's Q product
        out = kb.fused_block(x, k, v, s.scale, self.norm1.weight.to(x.dtype),
                             self.norm1.bias.to(x.dtype), wqkv[:s.dim].to(x.dtype),
                             bq.to(x.dtype), *tail, xn)
        return out, thw

    def _skip(self, x: torch.Tensor, thw: THW, decoder_kernel: bool = False) -> torch.Tensor:
        """The residual skip of the unnormed input: trilinear upsample
        (decoder), MaxPool (encoder Q-pool) or identity. ``decoder_kernel``:
        the block is on B5's route (see :func:`upsample_tokens_trilinear`)."""
        s = self.spec
        if s.upsample_q:
            if not s.skip_upsample_on:
                return x
            return upsample_tokens_trilinear(x, thw, s.stride_q, train=self.training,
                                             decoder_kernel=decoder_kernel)[0]
        if s.skip_pool_on:
            pad = tuple(int(k // 2) for k in s.skip_kernel)
            return pool_tokens_max(x, thw, s.skip_kernel, s.stride_q, pad, s.has_cls)[0]
        return x

    def _branches(self, x: torch.Tensor, thw: THW, mask, return_attn: bool, rows):
        """LN1, the attention (``rows``: of the output rows only) and the
        skip of the unnormed input, cut to the same rows."""
        xn = ops.layer_norm(x, self.norm1.weight, self.norm1.bias)
        x_block, thw_new, *attn = self.attn(xn, thw, mask, return_attn, rows)
        skip = self._skip(x, thw)
        if rows is not None:
            skip = skip[:, rows[0]:rows[0] + rows[1]]
        return skip, x_block, thw_new, attn

    def forward_composite(
        self, x: torch.Tensor, thw: THW, mask: Optional[torch.Tensor] = None,
        return_attn: bool = False, rows: Optional[Tuple[int, int]] = None,
    ):
        """The block through K1 and K2 (the route of every block the
        whole-block kernels do not take); with ``return_attn``, through
        :func:`attention_probs` and K2, returning the probabilities too.
        ``rows`` (first, count): those output rows only (the seq axis)."""
        skip, x_block, thw_new, attn = self._branches(x, thw, mask, return_attn, rows)
        out = kb.fused_mlp_tail(skip + x_block, *self._tail_weights(x.dtype, attn_proj=False)[2:])
        return (out, thw_new, *attn)

    def forward_train(
        self, x: torch.Tensor, thw: THW, mask: Optional[torch.Tensor] = None,
        drop: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, return_attn: bool = False,
        rows: Optional[Tuple[int, int]] = None,
    ):
        """The training route (the JAX composite at ``deterministic=False``):
        K1 forward with B8 backward (with ``return_attn``, the
        differentiable :func:`attention_probs` instead, its probabilities
        returned too), skip + drop_path(attention branch), then the B7 tail
        with the MLP-branch mask as its per-sample factor (ones without
        stochastic depth). The weights stay in their own dtype: the ops and
        B7's Function cast them in the graph. ``rows``: as
        :meth:`forward_composite`'s."""
        skip, x_block, thw_new, attn = self._branches(x, thw, mask, return_attn, rows)
        if drop is not None:
            x_block = ops.drop_path(x_block, drop[0])
            dp = drop[1]
        else:
            dp = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
        out = kb.mlp_tail_train(skip + x_block, *self._tail_weights(attn_proj=False)[2:], dp)
        return (out, thw_new, *attn)

    def forward_rows(self, x: torch.Tensor, thw: THW, rows: Tuple[int, int],
                     drop: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, THW]:
        """The rows [first, first + count) of the block's output from its
        whole input ``x`` (the seq axis's stripe, ``models/csts.py``): on the
        K1+K2 route and in training, K/V and the pooled Q from every token,
        K1 on those Q rows, the skip and the tail (K2, B7) on those rows; a
        whole-block route (B3, B4, B5) runs the block whole and keeps them."""
        if self.training:
            return self.forward_train(x, thw, drop=drop, rows=rows)
        if block_route(self.spec, None, thw) == "composite":
            return self.forward_composite(x, thw, rows=rows)
        out, thw_new = self.forward(x, thw)
        return out[:, rows[0]:rows[0] + rows[1]], thw_new


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


def extract_audio_attention(attn: torch.Tensor, thw: THW) -> torch.Tensor:
    """Per-frame audio→video attention map, min-max rescaled
    (av_attention.py:360-370; ``csts_tpu/models/mvit.py:864-880``): row
    T·H·W + f of the spatial fusion's probabilities, the audio token of
    frame f, over frame f's video columns. ``attn``: (B, N, L, L) fp32,
    L = T·H·W + T. Returns (B, N, T, H, W) in [0, 1]."""
    t, h, w = thw
    hw = h * w
    rows = torch.stack([attn[:, :, t * hw + f, hw * f:hw * (f + 1)] for f in range(t)], dim=2)
    amax = rows.amax(dim=-1, keepdim=True)
    amin = rows.amin(dim=-1, keepdim=True)
    rescaled = (rows - amin) / (amax - amin + 1e-8)
    return rescaled.reshape(*rescaled.shape[:2], t, h, w)

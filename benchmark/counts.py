"""Operations and bytes, counted analytically from shapes.

* :func:`csts_forward_flops`, :func:`mvit_forward_flops`: the model's
  floating-point operations a clip (a multiply-add is 2), from the
  configuration's block shapes alone (``reference.arch``): the products of
  the linears, the convolutions (a depthwise one: its taps a channel), the
  attention's two products; norms, softmax, GELU, pools and resizes are not
  counted. The count depends on the model and the batch only, never on
  which kernels run, so MFU still bounds a gain when a kernel is replaced.
  :func:`csts_train_flops` is forward plus backward (twice the forward's
  products, the input gradient of the first convolutions aside), with no
  recomputation counted.
* :func:`kernel_work`: the operations and bytes one launch of one of the
  port's kernels needs, from its arguments' shapes: each input read once and
  each output written once, whatever the kernel's tiling reads again.
* :data:`PEAK_FLOPS`, :data:`PEAK_BYTES`: one H100 SXM's published dense
  bf16 rate and HBM bandwidth (NVIDIA's data sheet, 700 W).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

from .reference.arch import THW, Block, CSTSArch, MViTArch

PEAK_FLOPS = 989e12  # bf16 dense, tensor cores
PEAK_BYTES = 3.35e12  # HBM3


def _n(thw) -> int:
    return math.prod(thw)


def block_flops(b: Block, thw: THW) -> int:
    """One block on grid ``thw`` (a cls token adds one row)."""
    cls = 1 if b.has_cls else 0
    l_in, l_q = _n(thw) + cls, _n(b.q_grid(thw)) + cls
    l_k = _n(b.kv_grid(thw)) + cls
    d, h = b.dim, b.hidden
    f = 2 * l_in * d * 3 * d  # qkv
    if b.pool_q:  # depthwise: the taps of each output (of each input when upsampling)
        f += 2 * math.prod(b.kernel_q) * d * (_n(thw) if b.upsample_q else l_q - cls)
    if b.pool_kv:
        f += 2 * 2 * math.prod(b.kernel_kv) * d * (l_k - cls)
    f += 4 * l_q * l_k * d  # q kᵀ and p v over all heads
    f += 2 * l_q * d * d  # proj
    f += 2 * l_q * d * h + 2 * l_q * h * b.dim_out  # fc1, fc2
    if b.dim != b.dim_out:
        f += 2 * l_q * d * b.dim_out
    return f


def _blocks_flops(blocks, thw: THW) -> Tuple[int, THW]:
    f = 0
    for b in blocks:
        f += block_flops(b, thw)
        thw = b.q_grid(thw)
    return f, thw


def _patch_flops(cin: int, cout: int, kernel, out_thw) -> int:
    return 2 * cout * cin * math.prod(kernel) * _n(out_thw)


def csts_forward_flops(a: CSTSArch, embed: bool = False) -> int:
    """One clip through CSTS-B; ``embed``: with EgoNCE's two projections."""
    f = _patch_flops(3, a.embed, a.patch_kernel, a.patch_dims)
    f += _patch_flops(1, a.embed, a.patch_kernel, a.audio_dims)
    fv, thw = _blocks_flops(a.video, a.patch_dims)
    fa, thw_a = _blocks_flops(a.audio, a.audio_dims)
    f += fv + fa
    td, t = a.token_dim, a.fusion_thw[0]
    f += 2 * td * td * _n(thw[1:]) * t + 2 * 2 * td * td * _n(thw_a[1:]) * t  # the fusion pools
    f += block_flops(a.fusion, (1, 1, _n(thw) + t))  # spatial fusion, dense under its mask
    f += block_flops(a.fusion, (1, 1, 2 * t))  # temporal fusion
    fd, thw = _blocks_flops(a.decoder, thw)
    f += fd + 2 * a.decoder[-1].dim_out * _n(thw)  # the 1x1x1 classifier
    if embed:
        f += 2 * 2 * td * a.nce_dim
    return f


def csts_train_flops(a: CSTSArch) -> int:
    """One clip's training step: the forward with the embeddings, and a
    backward of twice its products (weight and input gradients), less the
    input gradient of the two patch embeddings, which nothing needs."""
    fwd = csts_forward_flops(a, embed=True)
    stems = (_patch_flops(3, a.embed, a.patch_kernel, a.patch_dims)
             + _patch_flops(1, a.embed, a.patch_kernel, a.audio_dims))
    return fwd + 2 * fwd - stems


def mvit_forward_flops(a: MViTArch) -> int:
    """One clip through the classifier (cls token on)."""
    f = _patch_flops(3, a.embed, a.patch_kernel, a.patch_dims)
    fb, _ = _blocks_flops(a.blocks, a.patch_dims)
    return f + fb + 2 * a.blocks[-1].dim_out * a.classes


# --- one launch of a port kernel, from its wrapper's arguments ---------------


def _bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _tail(m: int, tail) -> Tuple[int, int]:
    """(flops, weight bytes) of LN2 → fc1 → GELU → fc2 (+ proj) over m rows;
    ``tail`` = (ln2_w, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, proj_w, proj_b)."""
    fc1_w, fc2_w, proj_w = tail[2], tail[4], tail[6]
    hidden, c = fc1_w.shape
    cout = fc2_w.shape[0]
    f = 2 * m * c * hidden + 2 * m * hidden * cout
    if proj_w is not None:
        f += 2 * m * c * cout
    return f, _bytes(*tail)


def kernel_work(kernel: str, args: tuple,
                mask_share: Optional[float] = None) -> Tuple[int, int]:
    """(flops, bytes) of one launch of ``kernel`` called with ``args`` (its
    wrapper's arguments in the order of its signature). ``mask_share``:
    for an attention with a mask, the share of (query, key) pairs it lets
    through, whose products alone the math needs."""
    if kernel == "K1":  # _attention_fwd(q, k, v, scale, mask, with_lse)
        q, k, v, _, mask, with_lse = args[:6]
        b, n, lq, hd = q.shape
        f = 4 * b * n * lq * k.shape[2] * hd * (1.0 if mask is None else mask_share)
        lse = 4 * b * n * lq if with_lse else 0
        return int(f), 2 * _bytes(q) + _bytes(k, v, mask) + lse
    if kernel == "B8":  # fused_attention_bwd(q, k, v, out, g, scale, lse)
        q, k, v, out, g = args[:5]
        b, n, lq, hd = q.shape
        f = 8 * b * n * lq * k.shape[2] * hd  # dV, dP, dQ, dK; S is the forward's
        return f, 2 * _bytes(q, k, v) + _bytes(out, g) + 4 * b * n * lq
    if kernel in ("K2", "B7"):  # (x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, proj_w, proj_b[, dp])
        x = args[0]
        c = x.shape[-1]
        m = x.numel() // c
        f, wb = _tail(m, args[1:9])
        cout, hidden = args[5].shape[0], args[3].shape[0]
        out = m * cout * x.element_size()
        hid = m * hidden * x.element_size() if kernel == "B7" else 0
        return f, _bytes(x) + wb + out + hid
    if kernel in ("K3", "B9a"):  # (x, thw): twice / four times the tokens out
        x = args[0]
        return 0, _bytes(x) * (3 if kernel == "K3" else 5)
    if kernel == "B3":  # fused_block(x, k, v, scale, ln1_w, ln1_b, wq, bq, wproj, bproj, *tail, xn)
        x, k, v = args[:3]
        b, l, c = x.shape
        lk = k.shape[2]
        tail = args[10:18]
        ft, wb = _tail(b * l, tail)
        f = 2 * b * l * c * c + 4 * b * l * lk * c + 2 * b * l * c * c + ft
        out = b * l * tail[4].shape[0] * x.element_size()
        return f, _bytes(x, k, v, args[18]) + _bytes(*args[4:10]) + wb + out
    if kernel in ("B4", "B5"):
        # fused_pool_block(q, thw, skip, k, v, scale, wconv, nq_w, nq_b, wproj, bproj, *tail)
        # fused_decoder_block(q, thw, stride, skip, k, v, scale, wconv, ..., *tail)
        off = 1 if kernel == "B5" else 0
        q, skip, k, v = args[0], args[2 + off], args[3 + off], args[4 + off]
        wconv = args[6 + off]
        b, l_in, c = q.shape
        lq, lk = skip.shape[1], k.shape[2]
        tail = args[11 + off:19 + off]
        ft, wb = _tail(b * lq, tail)
        taps = math.prod(wconv.shape[2:])
        f = (2 * taps * c * (b * l_in if kernel == "B5" else b * lq) + 4 * b * lq * lk * c
             + 2 * b * lq * c * c + ft)
        out = b * lq * tail[4].shape[0] * q.element_size()
        return f, _bytes(q, skip, k, v) + _bytes(*args[6 + off:11 + off]) + wb + out
    raise ValueError(f"no count for kernel {kernel}")


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


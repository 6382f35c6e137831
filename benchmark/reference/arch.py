"""The block-by-block shapes of CSTS-B and of the MViT classifier, derived
from a configuration file's keys (PySlowFast's MViT constructor and the CSTS
model's, ``slowfast/models/video_model_builder.py`` and
``custom_multimodal_builder.py``), kept with the benchmark so that the
reference and the operation counts never move with the program.

A configuration is the flat ``{"SECTION.KEY": value}`` dict of a
``benchmark/configs/<name>.json`` file's ``set``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

THW = Tuple[int, int, int]


def round_width(width, multiplier, min_width=1, divisor=1):
    """PySlowFast's channel rounding (``slowfast/models/utils.py``)."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if out < 0.9 * width:
        out += divisor
    return int(out)


@dataclasses.dataclass(frozen=True)
class Block:
    """One multiscale block: attention (pooled or upsampled Q, pooled K/V),
    the residual skip, the MLP and, where the width changes, its proj."""

    dim: int
    dim_out: int
    heads: int
    mlp_ratio: float
    qkv_bias: bool
    drop_path: float
    kernel_q: tuple = ()
    kernel_kv: tuple = ()
    stride_q: tuple = ()
    stride_kv: tuple = ()
    upsample_q: bool = False
    has_cls: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def pool_q(self) -> bool:
        return bool(self.kernel_q) and not (math.prod(self.kernel_q) == 1
                                            and math.prod(self.stride_q) == 1)

    @property
    def pool_kv(self) -> bool:
        return bool(self.kernel_kv) and not (math.prod(self.kernel_kv) == 1
                                             and math.prod(self.stride_kv) == 1)

    @property
    def hidden(self) -> int:
        # the decoder blocks size their MLP from dim_out
        return int((self.dim_out if self.upsample_q else self.dim) * self.mlp_ratio)

    def q_grid(self, thw: THW) -> THW:
        """The output grid (Q's, after its pool or upsample)."""
        if not self.pool_q:
            return thw
        if self.upsample_q:
            return tuple((d - 1) * s - 2 * (k // 2) + k + (s - 1)
                         for d, k, s in zip(thw, self.kernel_q, self.stride_q))
        return tuple((d + 2 * (k // 2) - k) // s + 1
                     for d, k, s in zip(thw, self.kernel_q, self.stride_q))

    def kv_grid(self, thw: THW) -> THW:
        if not self.pool_kv:
            return thw
        return tuple((d + 2 * (k // 2) - k) // s + 1
                     for d, k, s in zip(thw, self.kernel_kv, self.stride_kv))


def _encoder_blocks(c: Dict, has_cls: bool = False) -> Tuple[List[Block], int]:
    """The video encoder's blocks (MViT's stage schedule) and its last head count."""
    depth = c["MVIT.DEPTH"]
    rate = c["MVIT.DROPPATH_RATE"]
    dpr = [rate * i / (depth - 1) if depth > 1 else 0.0 for i in range(depth)]
    dim_mul, head_mul = [1.0] * (depth + 1), [1.0] * (depth + 1)
    for i, m in c["MVIT.DIM_MUL"]:
        dim_mul[int(i)] = m
    for i, m in c["MVIT.HEAD_MUL"]:
        head_mul[int(i)] = m
    kvq = tuple(c["MVIT.POOL_KVQ_KERNEL"])
    stride_q = [()] * depth
    for e in c["MVIT.POOL_Q_STRIDE"]:
        stride_q[int(e[0])] = tuple(int(s) for s in e[1:])
    stride_kv, s_kv = [()] * depth, list(c["MVIT.POOL_KV_STRIDE_ADAPTIVE"])
    for i in range(depth):
        if stride_q[i]:
            s_kv = [max(s_kv[d] // stride_q[i][d], 1) for d in range(3)]
        stride_kv[i] = tuple(s_kv)
    blocks, heads, dim = [], c["MVIT.NUM_HEADS"], c["MVIT.EMBED_DIM"]
    for i in range(depth):
        heads = round_width(heads, head_mul[i])
        dim = round_width(dim, dim_mul[i], divisor=heads)
        dim_out = round_width(dim, dim_mul[i + 1], divisor=round_width(heads, head_mul[i + 1]))
        blocks.append(Block(dim, dim_out, heads, c["MVIT.MLP_RATIO"], c["MVIT.QKV_BIAS"],
                            dpr[i], kvq if stride_q[i] else (), kvq, stride_q[i], stride_kv[i],
                            has_cls=has_cls))
    return blocks, heads


def _after(thw: THW, blocks) -> THW:
    for b in blocks:
        thw = b.q_grid(thw)
    return thw


@dataclasses.dataclass(frozen=True)
class CSTSArch:
    crop: int
    frames: int
    freq_bins: int
    window: int
    embed: int
    patch_kernel: tuple
    patch_stride: tuple
    patch_padding: tuple
    patch_dims: THW
    audio_dims: THW
    video: tuple
    audio: tuple
    video_groups: tuple
    fusion_thw: THW
    audio_fusion_thw: THW
    fusion: Block
    decoder: tuple
    nce_dim: int = 256

    @property
    def token_dim(self) -> int:
        return self.video[-1].dim_out


def csts_arch(c: Dict) -> CSTSArch:
    """CSTS-B: 16 video + 4 audio encoder blocks in four interleaved groups,
    the spatial and temporal fusion blocks and four decoder blocks."""
    if c["MVIT.CLS_EMBED_ON"] or c.get("MVIT.SPATIAL_AUDIO_ATTN", False):
        raise ValueError("the reference CSTS runs without a cls token and without "
                         "SPATIAL_AUDIO_ATTN, as the published configuration")
    crop, frames = c["DATA.TRAIN_CROP_SIZE"], c["DATA.NUM_FRAMES"]
    k, s, p = (tuple(c[f"MVIT.PATCH_{n}"]) for n in ("KERNEL", "STRIDE", "PADDING"))
    fb, win = c["DATA.AUDIO_FREQ_BINS"], c["DATA.AUDIO_WINDOW"]
    patch = (frames // s[0], crop // s[1], crop // s[2])
    audio_dims = (frames // s[0], fb // s[1], win // s[2])
    video, heads = _encoder_blocks(c)
    e, r, qb = c["MVIT.EMBED_DIM"], c["MVIT.MLP_RATIO"], c["MVIT.QKV_BIAS"]
    audio = tuple(
        Block(d, do, h, r, qb, 0.0, kq, (3, 3, 3), sq, skv)
        for d, do, h, kq, sq, skv in zip(
            (e, 2 * e, 4 * e, 8 * e), (2 * e, 4 * e, 8 * e, 8 * e), (1, 2, 4, 8),
            ((), (3, 3, 3), (3, 3, 3), (3, 3, 3)), ((), (1, 2, 2), (1, 2, 2), (1, 2, 2)),
            ((1, 8, 8), (1, 4, 4), (1, 2, 2), (1, 1, 1))))
    q_blocks = sorted(int(x[0]) for x in c["MVIT.POOL_Q_STRIDE"])
    groups = ((0, q_blocks[0]), (q_blocks[0], q_blocks[1]), (q_blocks[1], q_blocks[2]),
              (q_blocks[2], len(video)))
    td = video[-1].dim_out
    decoder = tuple(
        Block(d, do, h, r, qb, 0.0, (3, 3, 3), (3, 3, 3), sq, skv, upsample_q=True)
        for d, do, h, sq, skv in zip(
            (8 * e, 8 * e, 4 * e, 2 * e), (8 * e, 4 * e, 2 * e, e), (8, 4, 4, 2),
            ((1, 2, 2), (1, 2, 2), (1, 2, 2), (2, 1, 1)),
            ((1, 2, 2), (1, 4, 4), (1, 8, 8), (1, 16, 16))))
    return CSTSArch(crop, frames, fb, win, e, k, s, p, patch, audio_dims, tuple(video),
                    audio, groups, _after(patch, video), _after(audio_dims, audio),
                    Block(td, td, heads, r, qb, 0.0), decoder)


@dataclasses.dataclass(frozen=True)
class MViTArch:
    crop: int
    frames: int
    embed: int
    patch_kernel: tuple
    patch_stride: tuple
    patch_padding: tuple
    patch_dims: THW
    blocks: tuple
    classes: int


def mvit_arch(c: Dict) -> MViTArch:
    """PySlowFast's MViT classifier with the cls token and separate position
    embeddings."""
    if not (c["MVIT.CLS_EMBED_ON"] and c["MVIT.SEP_POS_EMBED"]):
        raise ValueError("the reference MViT takes the cls token and separate position "
                         "embeddings, as MVIT_B_16x4_CONV.yaml")
    crop, frames = c["DATA.TRAIN_CROP_SIZE"], c["DATA.NUM_FRAMES"]
    k, s, p = (tuple(c[f"MVIT.PATCH_{n}"]) for n in ("KERNEL", "STRIDE", "PADDING"))
    blocks, _ = _encoder_blocks(c, has_cls=True)
    return MViTArch(crop, frames, c["MVIT.EMBED_DIM"], k, s, p,
                    (frames // s[0], crop // s[1], crop // s[2]), tuple(blocks),
                    c["MODEL.NUM_CLASSES"])

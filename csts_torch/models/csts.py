"""CSTS: the audio-visual egocentric gaze model (``csts_tpu/models/csts.py``).

Dual-branch MViT encoder (16-block video / 4-block audio), correlation-based
spatial + temporal audio-visual fusion, and a 4-block decoder emitting per-frame
gaze heatmap logits ``(B, T_out, 64, 64, 1)`` (channels-last, as the JAX
package). The forward is the JAX ``csts_apply`` with ``return_embed``: at
``deterministic=True`` in eval mode, and at ``deterministic=False`` in
training mode, with the stochastic-depth masks passed in (``drop``) and every
block on its training route (``mvit.MultiScaleBlock.forward_train``).

The stem-skip head uses the classify-first side of the exact
classifier/resize commute (the JAX default, ``HEAD_COMMUTE``): the 1x1x1
classifier is a per-voxel linear map, so the stem grid is classified to one
channel first and that map is T-resized (K3) and added to the classified
decoder grid; the bias rides the decoder term once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from csts_torch import ops
from csts_torch.config import Config
from csts_torch.kernels import upsample as kup
from csts_torch.models.mvit import (
    THW,
    AttentionSpec,
    MultiScaleBlock,
    build_inframe_mask,
    round_width,
)


@dataclasses.dataclass(frozen=True)
class CSTSSpec:
    """All static metadata for one CSTS instantiation (field for field the JAX one)."""

    # inputs
    crop_size: int
    num_frames: int
    in_chans: int
    patch_kernel: Tuple[int, ...]
    patch_stride: Tuple[int, ...]
    patch_padding: Tuple[int, ...]
    embed_dim: int
    patch_dims: THW  # (T, H, W) of the video token grid after the stem
    audio_patch_dims: THW  # (T, F', S') of the audio token grid after the stem
    sep_pos_embed: bool
    # encoder
    video_blocks: Tuple[AttentionSpec, ...]
    audio_blocks: Tuple[AttentionSpec, ...]
    # execution groups: video blocks [0:g0], [g0:g1], ... interleaved with audio blocks
    video_groups: Tuple[Tuple[int, int], ...]
    audio_groups: Tuple[Tuple[int, int], ...]
    # fusion
    token_dim: int
    fusion_thw: THW
    audio_fusion_thw: THW
    spatial_fusion: AttentionSpec
    temporal_fusion: AttentionSpec
    spatial_audio_attn: bool
    # decoder
    decoder_blocks: Tuple[AttentionSpec, ...]
    # losses
    use_nce: bool
    nce_embed_dim: int = 256
    # input normalization, applied on-device when the feed ships raw uint8 frames
    data_mean: Tuple[float, ...] = (0.45, 0.45, 0.45)
    data_std: Tuple[float, ...] = (0.225, 0.225, 0.225)
    # compute
    dtype: str = "float32"
    remat: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def build_spec(cfg: Config) -> CSTSSpec:
    """Derive the block-by-block architecture from config, exactly as the
    reference's constructor (``custom_multimodal_builder.py:25-301``) and the
    JAX ``build_spec``."""
    assert cfg.DATA.TRAIN_CROP_SIZE == cfg.DATA.TEST_CROP_SIZE
    assert not cfg.MVIT.CLS_EMBED_ON, "CSTS runs without a cls token (yaml: CLS_EMBED_ON False)"
    assert cfg.MVIT.MODE == "conv"
    assert cfg.MVIT.NORM == "layernorm"

    spatial_size = cfg.DATA.TRAIN_CROP_SIZE
    temporal_size = cfg.DATA.NUM_FRAMES
    patch_stride = tuple(cfg.MVIT.PATCH_STRIDE)
    patch_kernel = tuple(cfg.MVIT.PATCH_KERNEL)
    patch_padding = tuple(cfg.MVIT.PATCH_PADDING)
    if cfg.MVIT.PATCH_2D:
        # 2-D patchify == 3-D conv with temporal extent 1
        patch_kernel = (1, *patch_kernel[-2:])
        patch_stride = (1, *patch_stride[-2:])
        patch_padding = (0, *patch_padding[-2:])
    patch_dims = (
        temporal_size // patch_stride[0],
        spatial_size // patch_stride[1],
        spatial_size // patch_stride[2],
    )
    audio_patch_dims = (
        temporal_size // patch_stride[0],
        cfg.DATA.AUDIO_FREQ_BINS // patch_stride[1],
        cfg.DATA.AUDIO_WINDOW // patch_stride[2],
    )
    depth = cfg.MVIT.DEPTH
    dpr = [float(x) for x in np.linspace(0, cfg.MVIT.DROPPATH_RATE, depth)]

    dim_mul = np.ones(depth + 1)
    head_mul = np.ones(depth + 1)
    for idx, mul in cfg.MVIT.DIM_MUL:
        dim_mul[int(idx)] = mul
    for idx, mul in cfg.MVIT.HEAD_MUL:
        head_mul[int(idx)] = mul

    pool_q = [() for _ in range(depth)]
    pool_kv = [() for _ in range(depth)]
    stride_q = [() for _ in range(depth)]
    stride_kv = [() for _ in range(depth)]

    for entry in cfg.MVIT.POOL_Q_STRIDE:
        i = int(entry[0])
        stride_q[i] = tuple(int(s) for s in entry[1:])
        if cfg.MVIT.POOL_KVQ_KERNEL is not None:
            pool_q[i] = tuple(cfg.MVIT.POOL_KVQ_KERNEL)
        else:
            pool_q[i] = tuple(s + 1 if s > 1 else s for s in stride_q[i])

    if cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE is not None:
        _stride_kv = list(cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE)
        pool_kv_stride = []
        for i in range(depth):
            if len(stride_q[i]) > 0:
                _stride_kv = [max(_stride_kv[d] // stride_q[i][d], 1) for d in range(3)]
            pool_kv_stride.append([i] + list(_stride_kv))
    else:
        pool_kv_stride = cfg.MVIT.POOL_KV_STRIDE or []

    for entry in pool_kv_stride:
        i = int(entry[0])
        stride_kv[i] = tuple(int(s) for s in entry[1:])
        if cfg.MVIT.POOL_KVQ_KERNEL is not None:
            pool_kv[i] = tuple(cfg.MVIT.POOL_KVQ_KERNEL)
        else:
            pool_kv[i] = tuple(s + 1 if s > 1 else s for s in stride_kv[i])

    fused = cfg.MODEL.FUSED_ATTENTION
    video_blocks = []
    num_heads = cfg.MVIT.NUM_HEADS
    embed_dim = cfg.MVIT.EMBED_DIM
    for i in range(depth):
        num_heads = round_width(num_heads, head_mul[i])
        embed_dim = round_width(embed_dim, dim_mul[i], divisor=num_heads)
        dim_out = round_width(
            embed_dim, dim_mul[i + 1], divisor=round_width(num_heads, head_mul[i + 1])
        )
        video_blocks.append(
            AttentionSpec(
                dim=embed_dim,
                dim_out=dim_out,
                num_heads=num_heads,
                mlp_ratio=cfg.MVIT.MLP_RATIO,
                qkv_bias=cfg.MVIT.QKV_BIAS,
                drop_path=dpr[i],
                kernel_q=pool_q[i],
                kernel_kv=pool_kv[i],
                stride_q=stride_q[i],
                stride_kv=stride_kv[i],
                fused=fused,
            )
        )

    # Audio branch: 4 blocks, dims e·{1,2,4,8} (the reference hard-codes
    # [96,192,384,768] for EMBED_DIM 96, custom_multimodal_builder.py:184-191).
    e = cfg.MVIT.EMBED_DIM
    audio_dims = [e, 2 * e, 4 * e, 8 * e]
    audio_dims_out = [2 * e, 4 * e, 8 * e, 8 * e]
    audio_heads = [1, 2, 4, 8]
    audio_kernel_q = [(), (3, 3, 3), (3, 3, 3), (3, 3, 3)]
    audio_kernel_kv = [(3, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3)]
    audio_stride_q = [(), (1, 2, 2), (1, 2, 2), (1, 2, 2)]
    audio_stride_kv = [(1, 8, 8), (1, 4, 4), (1, 2, 2), (1, 1, 1)]
    audio_blocks = tuple(
        AttentionSpec(
            dim=audio_dims[i],
            dim_out=audio_dims_out[i],
            num_heads=audio_heads[i],
            mlp_ratio=cfg.MVIT.MLP_RATIO,
            qkv_bias=cfg.MVIT.QKV_BIAS,
            drop_path=0.0,
            kernel_q=audio_kernel_q[i],
            kernel_kv=audio_kernel_kv[i],
            stride_q=audio_stride_q[i],
            stride_kv=audio_stride_kv[i],
            fused=fused,
        )
        for i in range(4)
    )

    token_dim = video_blocks[-1].dim_out
    # interleaved execution groups: the Q-pool stage-transition blocks bound them
    q_blocks = sorted(int(e[0]) for e in cfg.MVIT.POOL_Q_STRIDE)
    assert len(q_blocks) == 3, "CSTS interleaving expects 3 Q-pool stage transitions"
    video_groups = (
        (0, q_blocks[0]),
        (q_blocks[0], q_blocks[1]),
        (q_blocks[1], q_blocks[2]),
        (q_blocks[2], depth),
    )
    audio_groups = ((0, 1), (1, 2), (2, 3), (3, 4))

    fusion_thw = _thw_after_blocks(patch_dims, video_blocks)
    audio_fusion_thw = _thw_after_blocks(audio_patch_dims, audio_blocks)
    assert audio_fusion_thw[0] == fusion_thw[0], "audio/video temporal grids must match"

    fusion_common = dict(
        dim=token_dim,
        dim_out=token_dim,
        num_heads=num_heads,
        mlp_ratio=cfg.MVIT.MLP_RATIO,
        qkv_bias=cfg.MVIT.QKV_BIAS,
        drop_path=0.0,
        kernel_q=(),
        kernel_kv=(),
        stride_q=(),
        stride_kv=(),
        fused=fused,
    )
    spatial_fusion = AttentionSpec(**fusion_common)
    temporal_fusion = AttentionSpec(**fusion_common)

    # Decoder: 4 blocks (custom_multimodal_builder.py:271-299)
    dec_dims = [8 * e, 8 * e, 4 * e, 2 * e]
    dec_dims_out = [8 * e, 4 * e, 2 * e, e]
    dec_heads = [8, 4, 4, 2]
    dec_stride_q = [(1, 2, 2), (1, 2, 2), (1, 2, 2), (2, 1, 1)]
    dec_stride_kv = [(1, 2, 2), (1, 4, 4), (1, 8, 8), (1, 16, 16)]
    decoder_blocks = tuple(
        AttentionSpec(
            dim=dec_dims[i],
            dim_out=dec_dims_out[i],
            num_heads=dec_heads[i],
            mlp_ratio=cfg.MVIT.MLP_RATIO,
            qkv_bias=cfg.MVIT.QKV_BIAS,
            drop_path=0.0,
            kernel_q=(3, 3, 3),
            kernel_kv=(3, 3, 3),
            stride_q=dec_stride_q[i],
            stride_kv=dec_stride_kv[i],
            upsample_q=True,
            fused=fused,
        )
        for i in range(4)
    )

    return CSTSSpec(
        crop_size=spatial_size,
        num_frames=temporal_size,
        in_chans=cfg.DATA.INPUT_CHANNEL_NUM[0],
        patch_kernel=patch_kernel,
        patch_stride=patch_stride,
        patch_padding=patch_padding,
        embed_dim=cfg.MVIT.EMBED_DIM,
        patch_dims=patch_dims,
        audio_patch_dims=audio_patch_dims,
        sep_pos_embed=cfg.MVIT.SEP_POS_EMBED,
        video_blocks=tuple(video_blocks),
        audio_blocks=audio_blocks,
        video_groups=video_groups,
        audio_groups=audio_groups,
        token_dim=token_dim,
        fusion_thw=fusion_thw,
        audio_fusion_thw=audio_fusion_thw,
        spatial_fusion=spatial_fusion,
        temporal_fusion=temporal_fusion,
        spatial_audio_attn=cfg.MVIT.SPATIAL_AUDIO_ATTN,
        decoder_blocks=decoder_blocks,
        use_nce="nce" in cfg.MODEL.LOSS_FUNC,
        data_mean=tuple(float(m) for m in cfg.DATA.MEAN),
        data_std=tuple(float(s) for s in cfg.DATA.STD),
        dtype="bfloat16" if cfg.TRAIN.MIXED_PRECISION else "float32",
        remat=cfg.MODEL.ACT_CHECKPOINT,
    )


def _conv_out(size: int, kernel: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - kernel) // stride + 1


def _thw_after_blocks(thw: THW, blocks) -> THW:
    t, h, w = thw
    for b in blocks:
        if b.pool_q_on:
            for d, s in enumerate(b.stride_q):
                k, p = b.kernel_q[d], b.kernel_q[d] // 2
                if d == 0:
                    t = _conv_out(t, k, s, p)
                elif d == 1:
                    h = _conv_out(h, k, s, p)
                else:
                    w = _conv_out(w, k, s, p)
    return (t, h, w)


# ----------------------------------------------------------------------------------
# model
# ----------------------------------------------------------------------------------


class PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, dim: int, kernel, stride, padding):
        super().__init__()
        self.proj = nn.Conv3d(in_chans, dim, kernel, stride, padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C_in) -> (B, T'·H'·W', dim) tokens."""
        p = self.proj
        out = ops.conv3d(x, p.weight, p.bias, p.stride, p.padding)
        return out.reshape(out.shape[0], -1, out.shape[-1])


def _conv(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    return ops.conv3d(x, conv.weight, conv.bias, conv.stride, conv.padding)


class CSTS(nn.Module):
    """The CSTS gaze model; parameter names are the reference's."""

    def __init__(self, spec: CSTSSpec):
        super().__init__()
        if spec.spatial_audio_attn:
            raise NotImplementedError(
                "MVIT.SPATIAL_AUDIO_ATTN needs the spatial fusion's attention "
                "probabilities, which the attention kernel never materialises; "
                "no shipped config sets it")
        self.spec = spec
        e = spec.embed_dim
        self.patch_embed = PatchEmbed(
            spec.in_chans, e, spec.patch_kernel, spec.patch_stride, spec.patch_padding)
        self.patch_embed_audio = PatchEmbed(
            1, e, spec.patch_kernel, spec.patch_stride, spec.patch_padding)
        t, h, w = spec.patch_dims
        ta, fa, sa = spec.audio_patch_dims
        if spec.sep_pos_embed:
            self.pos_embed_spatial = nn.Parameter(torch.zeros(1, h * w, e))
            self.pos_embed_temporal = nn.Parameter(torch.zeros(1, t, e))
            self.pos_embed_spatial_audio = nn.Parameter(torch.zeros(1, fa * sa, e))
            self.pos_embed_temporal_audio = nn.Parameter(torch.zeros(1, ta, e))
        else:
            self.pos_embed = nn.Parameter(torch.zeros(1, t * h * w, e))
            self.pos_embed_audio = nn.Parameter(torch.zeros(1, ta * fa * sa, e))
        self.blocks = nn.ModuleList(MultiScaleBlock(b) for b in spec.video_blocks)
        self.blocks_audio = nn.ModuleList(MultiScaleBlock(b) for b in spec.audio_blocks)
        td = spec.token_dim
        if spec.use_nce:
            self.vision_proj = nn.Linear(td, spec.nce_embed_dim)
            self.audio_proj = nn.Linear(td, spec.nce_embed_dim)
        fh, fw = spec.fusion_thw[1:]
        afh, afw = spec.audio_fusion_thw[1:]
        self.vision_pool = nn.Conv3d(td, td, (1, fh, fw))
        self.audio_pool = nn.Conv3d(td, td, (1, afh, afw))
        self.audio_pool2 = nn.Conv3d(td, td, (1, afh, afw))
        self.temporal_fusion = MultiScaleBlock(spec.temporal_fusion)
        self.spatial_fusion = MultiScaleBlock(spec.spatial_fusion)
        for i, b in enumerate(spec.decoder_blocks):
            self.add_module(f"decode_block{i + 1}", MultiScaleBlock(b))
        self.classifier = nn.Conv3d(spec.decoder_blocks[-1].dim_out, 1, (1, 1, 1))
        self.register_buffer(
            "inframe_mask",
            torch.from_numpy(build_inframe_mask(spec.fusion_thw, spec.fusion_thw[0])),
            persistent=False,
        )

    def _pos_embed(self, audio: bool) -> torch.Tensor:
        t, h, w = self.spec.audio_patch_dims if audio else self.spec.patch_dims
        if self.spec.sep_pos_embed:
            sfx = "_audio" if audio else ""
            spatial = getattr(self, f"pos_embed_spatial{sfx}")
            temporal = getattr(self, f"pos_embed_temporal{sfx}")
            return spatial.repeat(1, t, 1) + temporal.repeat_interleave(h * w, dim=1)
        return self.pos_embed_audio if audio else self.pos_embed

    def _encoder_block(self, block: MultiScaleBlock, x: torch.Tensor, thw: THW, drop=None):
        """One encoder block; in training with MODEL.ACT_CHECKPOINT
        (``spec.remat``) its activations are recomputed in the backward, as
        the JAX package's ``jax.checkpoint`` around ``_encoder_block``. The
        block draws no randomness (its masks are passed in) and its kernels
        give the same result when run again, so the RNG state is not kept."""
        if self.spec.remat and self.training:
            return checkpoint(block, x, thw, drop=drop, use_reentrant=False,
                              preserve_rng_state=False)
        return block(x, thw, drop=drop)

    def forward(self, video: torch.Tensor, audio: torch.Tensor, return_embed: bool = False,
                drop=None):
        """video: (B, T, H, W, 3) frames (float, or raw uint8 normalised here);
        audio: (B, T, F, S, 1) log-STFT slices; drop: in training, one entry
        per video block from ``ops.sample_drop_masks`` (None: no stochastic
        depth). Activations run in ``spec.compute_dtype`` whatever the
        weights' dtype, as the JAX ``csts_apply``. Returns logits (B, T_out,
        H', W', 1), and with ``return_embed`` also the NCE embeddings."""
        spec = self.spec
        cdt = spec.compute_dtype
        if drop is None:
            drop = [None] * len(self.blocks)
        if not video.is_floating_point():
            mean = torch.tensor(spec.data_mean, dtype=cdt, device=video.device)
            std = torch.tensor(spec.data_std, dtype=cdt, device=video.device)
            video = (video.to(cdt) / 255.0 - mean) / std
        else:
            video = video.to(cdt)
        audio = audio.to(cdt)

        x = self.patch_embed(video) + self._pos_embed(False).to(cdt)
        y = self.patch_embed_audio(audio) + self._pos_embed(True).to(cdt)
        thw: THW = spec.patch_dims
        thw_audio: THW = spec.audio_patch_dims

        # interleaved encoder groups, keeping the decoder's skip features
        inter_feat = [(x, thw)]
        groups = list(zip(spec.video_groups, spec.audio_groups))
        for gi, ((vs, ve), (as_, ae)) in enumerate(groups):
            for i in range(vs, ve):
                x, thw = self._encoder_block(self.blocks[i], x, thw, drop[i])
            if gi < len(groups) - 1:
                inter_feat.append((x, thw))
            for i in range(as_, ae):
                y, thw_audio = self._encoder_block(self.blocks_audio[i], y, thw_audio)

        # spatial-temporal fusion (custom_multimodal_builder.py:413-462)
        b = x.shape[0]
        t = spec.fusion_thw[0]
        td = spec.token_dim
        y_grid = y.reshape(b, *thw_audio, td)
        y_spatial = _conv(self.audio_pool, y_grid).reshape(b, t, td)
        av_spatial = torch.cat([x, y_spatial], dim=1)
        av_spatial, _ = self.spatial_fusion(av_spatial, thw, mask=self.inframe_mask)
        n_video = x.shape[1]
        x_spatial = av_spatial[:, :n_video]

        x_grid = x.reshape(b, *thw, td)
        x_temporal = _conv(self.vision_pool, x_grid).reshape(b, t, td)
        y_temporal = _conv(self.audio_pool2, y_grid).reshape(b, t, td)
        av_temporal = torch.cat([x_temporal, y_temporal], dim=1)
        av_temporal, _ = self.temporal_fusion(av_temporal, (2, 2, 2))

        x_weights = av_temporal[:, :t]
        x_reweight = (x_spatial.reshape(b, *thw, td) * x_weights[:, :, None, None, :])
        x_reweight = x_reweight.reshape(b, n_video, td)
        y_weights = av_temporal[:, t:]
        y_reweight = (y_grid * y_weights[:, :, None, None, :]).reshape(b, -1, td)

        # decoder (custom_multimodal_builder.py:465-481)
        feat = x_reweight
        n_dec = len(spec.decoder_blocks)
        for i in range(n_dec):
            feat, thw = getattr(self, f"decode_block{i + 1}")(feat, thw)
            if i < n_dec - 1:
                feat = feat + inter_feat[-(i + 1)][0]

        # head: classify first, then T-resize the 1-channel stem map (exact commute)
        stem_feat, stem_thw = inter_feat[0]
        logits = _conv(self.classifier, feat.reshape(b, *thw, -1))
        w = self.classifier.weight.reshape(1, -1).to(stem_feat.dtype)
        stem_cls = ops.linear(stem_feat, w)  # (B, L_stem, 1), no bias
        t2 = kup.t2_upsample_train if self.training else kup.t2_upsample
        logits = logits + t2(stem_cls, stem_thw).reshape(logits.shape)

        if not return_embed:
            return logits
        x_embed = ops.linear(x_reweight.mean(dim=1), self.vision_proj.weight, self.vision_proj.bias)
        y_embed = ops.linear(y_reweight.mean(dim=1), self.audio_proj.weight, self.audio_proj.bias)
        return logits, x_embed, y_embed


def init_params(model: CSTS, generator: torch.Generator) -> None:
    """Seeded random weights with the JAX ``csts_init`` rules: linears and
    position embeddings trunc-normal(std 0.02) with zero biases, LayerNorms
    ones/zeros, convolutions kaiming-uniform (U(±1/sqrt(fan_in)), bias too)."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, nn.Linear):
                _trunc_normal_(mod.weight, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (nn.Conv3d, nn.ConvTranspose3d)):
                fan_in = mod.weight[0].numel() if isinstance(mod, nn.Conv3d) else \
                    math.prod(mod.kernel_size)
                bound = 1.0 / math.sqrt(fan_in)
                mod.weight.uniform_(-bound, bound, generator=generator)
                if mod.bias is not None:
                    mod.bias.uniform_(-bound, bound, generator=generator)
        for name, p in model.named_parameters(recurse=False):
            _trunc_normal_(p, generator)


def _trunc_normal_(t: torch.Tensor, generator: torch.Generator, std: float = 0.02) -> None:
    """std · N(0, 1) truncated to ±2 (torch's trunc_normal_ bounds), by resampling."""
    vals = torch.randn(t.shape, generator=generator, device=t.device)
    bad = vals.abs() > 2.0
    while bad.any():
        vals[bad] = torch.randn(int(bad.sum()), generator=generator, device=t.device)
        bad = vals.abs() > 2.0
    t.copy_(vals * std)

"""CSTS: the audio-visual egocentric gaze model (``csts_tpu/models/csts.py``).

Dual-branch MViT encoder (16-block video / 4-block audio), correlation-based
spatial + temporal audio-visual fusion, and a 4-block decoder emitting per-frame
gaze heatmap logits ``(B, T_out, 64, 64, 1)`` (channels-last, as the JAX
package). The forward is the JAX ``csts_apply`` with ``return_embed``: at
``deterministic=True`` in eval mode, and at ``deterministic=False`` in
training mode, with the stochastic-depth masks passed in (``drop``) and every
block on its training route (``mvit.MultiScaleBlock.forward_train``).

The stem-skip head uses the classify-first side of the exact
classifier/resize commute while :data:`HEAD_COMMUTE` is set (the JAX
package's switch and default): the 1x1x1 classifier is a per-voxel linear
map, so the stem grid is classified to one channel first and that map is
T-resized (K3) and added to the classified decoder grid; the bias rides
the decoder term once. Off, the stem grid is T-resized whole, added to the
decoder grid, and the sum classified.

The forward's whole surface is JAX's ``csts_apply``: the fusion blocks'
attention maps (``return_spatial_attn``, ``return_temporal_attn``: those
blocks then take the plain attention core, ``mvit.block_route``'s
"attn_map"), named activations (``capture``, :func:`extract_activations`)
and MVIT.SPATIAL_AUDIO_ATTN (the spatial fusion's audio→video maps scale
the temporal branch's video grid).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from csts_torch import ops
from csts_torch.config import Config
from csts_torch.kernels import upsample as kup
from csts_torch.parallel import mesh, pipeline
from csts_torch.models.mvit import (
    THW,
    AttentionSpec,
    MultiScaleBlock,
    build_inframe_mask,
    extract_audio_attention,
    round_width,
    upsample_tokens_trilinear,
)
from csts_torch.utils import tracing

# The JAX package's switch (``csts_tpu/models/csts.py:37``, used at :628-647):
# classify the stem skip before its T-resize (exact commute). JAX takes this
# side only with its resize switch SPLIT_AXES_T_FIRST on too (the other XLA
# lowering made it slow); the port has one resize, so it reads this alone.
HEAD_COMMUTE = True


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

    def _seq_block(self, block: MultiScaleBlock, x: torch.Tensor, thw: THW, drop=None):
        """One encoder block on this rank's stripe ``x`` of the seq axis:
        the stripes gathered (the backward sums the ranks' gradients), the
        stripe of the output computed (``forward_rows``), the block's
        parameters marked as computed in part. An output token count the
        axis does not divide ends the stripes: the block runs whole on
        every rank. Returns (tokens, thw, whether striped)."""
        thw_out = _thw_after_blocks(thw, [block.spec])
        n_out = int(np.prod(thw_out))
        if not mesh.seq_divides(n_out):
            x = mesh.gather(x, mesh.SEQ_AXIS, 1, partial=False)
            return (*self._encoder_block(block, x, thw, drop), False)
        x = mesh.gather(x, mesh.SEQ_AXIS, 1, partial=True)
        mesh.note_partial(mesh.SEQ_AXIS, mesh.module_params(block))
        rows = mesh.seq_rows(n_out)
        if self.spec.remat and self.training:
            out, thw = checkpoint(block.forward_rows, x, thw, rows, drop, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            out, thw = block.forward_rows(x, thw, rows, drop)
        return out, thw, True

    def _pipelined_run_len(self, lo: int, hi: int, batch: int, capture) -> int:
        """The blocks from ``lo`` that run as a GPipe pipeline over the
        installed pipe axis (JAX's ``_pipelined_run_len``,
        ``csts_tpu/models/csts.py:475-492``): none with ``capture``, without
        a pipe axis of S ≥ 2, or with a batch M microbatches do not divide;
        else the run of blocks with ``lo``'s spec (drop-path aside) at
        ``dim == dim_out`` with no pool or upsample, cut to a multiple of S,
        if that is 2 or more."""
        S = pipeline.pipe_size() if capture is None else None
        if S is None or batch % pipeline.effective_microbatches(S):
            return 0
        blocks = self.spec.video_blocks
        b0 = blocks[lo]
        if b0.dim != b0.dim_out or b0.pool_q_on or b0.upsample_q:
            return 0
        j = lo + 1
        while j < hi and dataclasses.replace(blocks[j], drop_path=b0.drop_path) == b0:
            j += 1
        n = ((j - lo) // S) * S
        return n if n >= 2 else 0

    def pipe_runs(self) -> List[Tuple[int, int]]:
        """(first, count) of each video block run the installed pipe axis
        pipelines at a batch its microbatches divide (``forward``'s runs)."""
        S = pipeline.pipe_size()
        if S is None:
            return []
        runs = []
        for vs, ve in self.spec.video_groups:
            i = vs
            while i < ve:
                n = self._pipelined_run_len(i, ve, pipeline.effective_microbatches(S), None)
                if n:
                    runs.append((i, n))
                i += max(n, 1)
        return runs

    def _pipelined_blocks(self, lo: int, n: int, x: torch.Tensor, thw: THW, drop,
                          striped: bool):
        """Video blocks [lo, lo + n) through ``pipeline.pipeline_blocks``:
        microbatch m takes the rows m, m + M, ... of each block's masks. On
        the seq axis's stripes (``striped``) each block is a ``_seq_block``
        (its input gathered whole, its stripe's rows computed; the run keeps
        the token count, so the output stays striped)."""
        M = pipeline.effective_microbatches(pipeline.pipe_size())

        def apply_one(j, z, m):
            d = drop[lo + j]
            if d is not None:
                d = tuple(t[m::M] for t in d)
            if striped:
                return self._seq_block(self.blocks[lo + j], z, thw, d)[0]
            return self._encoder_block(self.blocks[lo + j], z, thw, d)[0]

        return pipeline.pipeline_blocks(apply_one, self.blocks[lo:lo + n], x)

    def forward(self, video: torch.Tensor, audio: torch.Tensor, return_embed: bool = False,
                drop=None, return_spatial_attn: bool = False,
                return_temporal_attn: bool = False, capture: Optional[dict] = None):
        """video: (B, T, H, W, 3) frames (float, or raw uint8 normalised here);
        audio: (B, T, F, S, 1) log-STFT slices; drop: in training, one entry
        per video block from ``ops.sample_drop_masks`` (None: no stochastic
        depth). Activations run in ``spec.compute_dtype`` whatever the
        weights' dtype, as the JAX ``csts_apply``. ``capture``: a dict
        filled with the activations named in :data:`CAPTURABLE`.

        Returns logits (B, T_out, H', W', 1); with ``return_embed`` the tuple
        (logits, vision embedding, audio embedding); else with either map
        asked for the list [logits, spatial map, temporal map] (each map
        only if asked): the spatial fusion's probabilities (B, N, L, L),
        L = T·H·W + T with the audio tokens last, and the temporal
        fusion's (B, N, 2T, 2T), both fp32. While a profiler records, the
        stages record the spans ``csts.model.encoders``, ``.fusion`` and
        ``.decoder`` (``utils/tracing.py``)."""
        spec = self.spec
        cdt = spec.compute_dtype

        def cap(name, value):
            if capture is not None:
                capture[name] = value

        if drop is None:
            drop = [None] * len(self.blocks)
        with tracing.span("csts.model.encoders"):
            if not video.is_floating_point():
                mean = torch.tensor(spec.data_mean, dtype=cdt, device=video.device)
                std = torch.tensor(spec.data_std, dtype=cdt, device=video.device)
                video = (video.to(cdt) / 255.0 - mean) / std
            else:
                video = video.to(cdt)
            audio = audio.to(cdt)

            x = self.patch_embed(video)
            y = self.patch_embed_audio(audio)
            cap("patch_embed", x)
            cap("patch_embed_audio", y)
            x = x + self._pos_embed(False).to(cdt)
            y = y + self._pos_embed(True).to(cdt)
            thw: THW = spec.patch_dims
            thw_audio: THW = spec.audio_patch_dims

            # interleaved encoder groups, keeping the decoder's skip features
            inter_feat = [(x, thw)]
            # the seq axis: each rank holds a stripe of each branch's tokens
            # between blocks while the token count divides it (JAX's seq_constraint)
            x_seq, y_seq = mesh.seq_divides(x.shape[1]), mesh.seq_divides(y.shape[1])
            x, y = mesh.seq_constraint(x), mesh.seq_constraint(y)

            def whole(t, striped):
                return mesh.gather(t, mesh.SEQ_AXIS, 1, partial=False) if striped else t

            def cap_tokens(name, t, striped):
                if capture is not None:
                    with torch.no_grad():
                        capture[name] = whole(t, striped)

            groups = list(zip(spec.video_groups, spec.audio_groups))
            for gi, ((vs, ve), (as_, ae)) in enumerate(groups):
                i = vs
                while i < ve:
                    n_pipe = self._pipelined_run_len(i, ve, x.shape[0], capture)
                    if n_pipe:
                        x = self._pipelined_blocks(i, n_pipe, x, thw, drop, x_seq)
                        i += n_pipe
                        continue
                    if x_seq:
                        x, thw, x_seq = self._seq_block(self.blocks[i], x, thw, drop[i])
                    else:
                        x, thw = self._encoder_block(self.blocks[i], x, thw, drop[i])
                    cap_tokens(f"blocks/{i}", x, x_seq)
                    i += 1
                if gi < len(groups) - 1:
                    inter_feat.append((whole(x, x_seq), thw))
                for i in range(as_, ae):
                    if y_seq:
                        y, thw_audio, y_seq = self._seq_block(self.blocks_audio[i], y, thw_audio)
                    else:
                        y, thw_audio = self._encoder_block(self.blocks_audio[i], y, thw_audio)
                    cap_tokens(f"blocks_audio/{i}", y, y_seq)
            x, y = whole(x, x_seq), whole(y, y_seq)

        with tracing.span("csts.model.fusion"):
            # spatial-temporal fusion (custom_multimodal_builder.py:413-462)
            b = x.shape[0]
            t = spec.fusion_thw[0]
            td = spec.token_dim
            y_grid = y.reshape(b, *thw_audio, td)
            y_spatial = _conv(self.audio_pool, y_grid).reshape(b, t, td)
            av_spatial = torch.cat([x, y_spatial], dim=1)
            spatial_attn = None
            if spec.spatial_audio_attn or return_spatial_attn:
                av_spatial, _, spatial_attn = self.spatial_fusion(
                    av_spatial, thw, mask=self.inframe_mask, return_attn=True)
            else:
                av_spatial, _ = self.spatial_fusion(av_spatial, thw, mask=self.inframe_mask)
            cap("spatial_fusion", av_spatial)
            n_video = x.shape[1]
            x_spatial = av_spatial[:, :n_video]

            x_grid = x.reshape(b, *thw, td)
            if spec.spatial_audio_attn:
                # the audio token's attention over its frame, averaged over heads,
                # scales that frame's video tokens (custom_multimodal_builder.py:434-441)
                audio_attn = extract_audio_attention(spatial_attn, spec.fusion_thw)
                x_grid = x_grid * audio_attn.mean(dim=1)[..., None].to(cdt)
            x_temporal = _conv(self.vision_pool, x_grid).reshape(b, t, td)
            y_temporal = _conv(self.audio_pool2, y_grid).reshape(b, t, td)
            av_temporal = torch.cat([x_temporal, y_temporal], dim=1)
            av_temporal, _, *temporal_attn = self.temporal_fusion(
                av_temporal, (2, 2, 2), return_attn=return_temporal_attn)
            cap("temporal_fusion", av_temporal)

            x_weights = av_temporal[:, :t]
            x_reweight = (x_spatial.reshape(b, *thw, td) * x_weights[:, :, None, None, :])
            x_reweight = x_reweight.reshape(b, n_video, td)
            y_weights = av_temporal[:, t:]
            y_reweight = (y_grid * y_weights[:, :, None, None, :]).reshape(b, -1, td)

        with tracing.span("csts.model.decoder"):
            # decoder (custom_multimodal_builder.py:465-481)
            feat = x_reweight
            n_dec = len(spec.decoder_blocks)
            for i in range(n_dec):
                feat, thw = getattr(self, f"decode_block{i + 1}")(feat, thw)
                if i < n_dec - 1:
                    feat = feat + inter_feat[-(i + 1)][0]
                cap(f"decode_block{i + 1}", feat)

            # head: the stem skip T-resized (K3 while kup.T2_SKIP_KERNEL is set)
            stem_feat, stem_thw = inter_feat[0]
            if HEAD_COMMUTE:  # classify first, then T-resize the 1-channel map
                logits = _conv(self.classifier, feat.reshape(b, *thw, -1))
                w = self.classifier.weight.reshape(1, -1).to(stem_feat.dtype)
                stem_cls = ops.linear(stem_feat, w)  # (B, L_stem, 1), no bias
                stem_up, _ = upsample_tokens_trilinear(stem_cls, stem_thw, (2, 1, 1),
                                                       train=self.training)
                logits = logits + stem_up.reshape(logits.shape)
            else:
                stem_up, _ = upsample_tokens_trilinear(stem_feat, stem_thw, (2, 1, 1),
                                                       train=self.training)
                logits = _conv(self.classifier, (feat + stem_up).reshape(b, *thw, -1))

        if return_embed:
            x_embed = ops.linear(x_reweight.mean(dim=1), self.vision_proj.weight,
                                 self.vision_proj.bias)
            y_embed = ops.linear(y_reweight.mean(dim=1), self.audio_proj.weight,
                                 self.audio_proj.bias)
            return logits, x_embed, y_embed
        if not (return_spatial_attn or return_temporal_attn):
            return logits
        return ([logits] + ([spatial_attn] if return_spatial_attn else [])
                + temporal_attn)


#: the layers :func:`extract_activations` captures (JAX's names, "/"-separated)
CAPTURABLE = (
    "patch_embed", "patch_embed_audio", "blocks/<i>", "blocks_audio/<i>",
    "spatial_fusion", "temporal_fusion", "decode_block<1-4>",
)


def extract_activations(model: CSTS, video: torch.Tensor, audio: torch.Tensor,
                        layers: Optional[Tuple[str, ...]] = None):
    """Runs the forward and returns ``(logits, {layer name: activation})``
    (``csts_tpu/models/csts.py:680-699``; the reference's forward hooks,
    ``GetWeightAndActivation``): every layer of :data:`CAPTURABLE`, or
    those named in ``layers``. Tokens (B, L, C) in the compute dtype, the
    stems' before their position embeddings."""
    acts: dict = {}
    logits = model(video, audio, capture=acts)
    if layers is not None:
        acts = {k: v for k, v in acts.items() if k in set(layers)}
    return logits, acts


def get_weights(model: CSTS, layers) -> dict:
    """{layer name: weights} by "/"-separated path into the module tree
    ("blocks/3/attn/qkv", "decode_block1/mlp/fc1/weight"): a parameter's
    tensor, or a module's state dict (``csts_tpu/models/csts.py:702-707``
    over the port's names)."""
    out = {}
    for name in layers:
        node = model
        for part in name.split("/"):
            node = node[int(part)] if isinstance(node, nn.ModuleList) else getattr(node, part)
        out[name] = node.state_dict() if isinstance(node, nn.Module) else node
    return out


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

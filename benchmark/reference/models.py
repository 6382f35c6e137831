"""The reference forwards of CSTS-B (Lai et al., ECCV 2024,
``custom_multimodal_builder.py`` and ``av_attention.py``) and of PySlowFast's
MViT classifier, in plain fp32 PyTorch over a ``{name: tensor}`` state dict
under the published parameter names, and each model's list of parameters
with its initialisation rule (:func:`csts_params`, :func:`mvit_params`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .arch import CSTSArch, MViTArch
from .nn import (Params, Round, block, block_params, conv3d, conv_params, ident, layer_norm,
                 linear, linear_params, norm_params)


def csts_params(a: CSTSArch) -> Dict[str, tuple]:
    """{name: (shape, init)} of CSTS-B, in the published module order."""
    e, td = a.embed, a.token_dim
    t, h, w = a.patch_dims
    ta, fa, sa = a.audio_dims
    out = {}
    out.update(conv_params("patch_embed.proj", e, 3, a.patch_kernel))
    out.update(conv_params("patch_embed_audio.proj", e, 1, a.patch_kernel))
    out.update({"pos_embed_spatial": ((1, h * w, e), "tn"), "pos_embed_temporal": ((1, t, e), "tn"),
                "pos_embed_spatial_audio": ((1, fa * sa, e), "tn"),
                "pos_embed_temporal_audio": ((1, ta, e), "tn")})
    for i, b in enumerate(a.video):
        out.update(block_params(f"blocks.{i}.", b))
    for i, b in enumerate(a.audio):
        out.update(block_params(f"blocks_audio.{i}.", b))
    out.update(linear_params("vision_proj", a.nce_dim, td))
    out.update(linear_params("audio_proj", a.nce_dim, td))
    fh, fw = a.fusion_thw[1:]
    afh, afw = a.audio_fusion_thw[1:]
    out.update(conv_params("vision_pool", td, td, (1, fh, fw)))
    out.update(conv_params("audio_pool", td, td, (1, afh, afw)))
    out.update(conv_params("audio_pool2", td, td, (1, afh, afw)))
    out.update(block_params("temporal_fusion.", a.fusion))
    out.update(block_params("spatial_fusion.", a.fusion))
    for i, b in enumerate(a.decoder):
        out.update(block_params(f"decode_block{i + 1}.", b))
    out.update(conv_params("classifier", 1, a.decoder[-1].dim_out, (1, 1, 1)))
    return out


def inframe_mask(thw, device) -> torch.Tensor:
    """The spatial fusion's additive mask (``av_attention.py``): tokens of
    frame f (its T·H·W video tokens, then audio token f last among the T
    audio tokens) see frame f's video tokens and audio token f; -1e8 elsewhere."""
    t, h, w = thw
    hw = h * w
    m = np.full((t * hw + t, t * hw + t), -1e8, dtype=np.float32)
    for f in range(t):
        rows = list(range(hw * f, hw * (f + 1))) + [t * hw + f]
        m[np.ix_(rows, rows)] = 0.0
    return torch.from_numpy(m).to(device)


def _pos(P: Params, sfx: str, thw) -> torch.Tensor:
    t, h, w = thw
    return (P[f"pos_embed_spatial{sfx}"].repeat(1, t, 1)
            + P[f"pos_embed_temporal{sfx}"].repeat_interleave(h * w, dim=1))


def csts_forward(P: Params, a: CSTSArch, video: torch.Tensor, audio: torch.Tensor,
                 drop: Optional[List] = None, embed: bool = False, rd: Round = ident):
    """video (B, T, H, W, 3), audio (B, T, F, S, 1) -> heatmap logits
    (B, T, H/4, W/4, 1); with ``embed`` also the vision and audio embeddings
    of EgoNCE. ``drop``: per video block None or its two (B,) factors."""
    drop = drop or [None] * len(a.video)
    x = conv3d(video, P["patch_embed.proj.weight"], P["patch_embed.proj.bias"], a.patch_stride,
               a.patch_padding, rd)
    y = conv3d(audio, P["patch_embed_audio.proj.weight"], P["patch_embed_audio.proj.bias"],
               a.patch_stride, a.patch_padding, rd)
    b = x.shape[0]
    x = x.reshape(b, -1, x.shape[-1]) + _pos(P, "", a.patch_dims)
    y = y.reshape(b, -1, y.shape[-1]) + _pos(P, "_audio", a.audio_dims)
    thw, thw_a = a.patch_dims, a.audio_dims
    skips = [(x, thw)]
    for g, (lo, hi) in enumerate(a.video_groups):
        for i in range(lo, hi):
            x, thw = block(P, f"blocks.{i}.", a.video[i], x, thw, drop=drop[i], rd=rd)
        if g < len(a.video_groups) - 1:
            skips.append((x, thw))
        y, thw_a = block(P, f"blocks_audio.{g}.", a.audio[g], y, thw_a, rd=rd)
    t, td = a.fusion_thw[0], a.token_dim
    y_grid = y.reshape(b, *thw_a, td)
    y_sp = conv3d(y_grid, P["audio_pool.weight"], P["audio_pool.bias"], 1, 0, rd).reshape(b, t, td)
    av = torch.cat([x, y_sp], dim=1)
    av, _ = block(P, "spatial_fusion.", a.fusion, av, thw, inframe_mask(a.fusion_thw, x.device),
                  rd=rd)
    n_video = x.shape[1]
    x_sp = av[:, :n_video]
    x_grid = x.reshape(b, *thw, td)
    x_t = conv3d(x_grid, P["vision_pool.weight"], P["vision_pool.bias"], 1, 0, rd).reshape(b, t, td)
    y_t = conv3d(y_grid, P["audio_pool2.weight"], P["audio_pool2.bias"], 1, 0, rd).reshape(b, t, td)
    av_t, _ = block(P, "temporal_fusion.", a.fusion, torch.cat([x_t, y_t], dim=1), (2, t, 1), rd=rd)
    x_rw = (x_sp.reshape(b, *thw, td) * av_t[:, :t, None, None, :]).reshape(b, n_video, td)
    y_rw = (y_grid * av_t[:, t:, None, None, :]).reshape(b, -1, td)
    feat = x_rw
    for i, blk in enumerate(a.decoder):
        feat, thw = block(P, f"decode_block{i + 1}.", blk, feat, thw, rd=rd)
        if i < len(a.decoder) - 1:
            feat = feat + skips[-(i + 1)][0]
    stem, stem_thw = skips[0]
    grid = stem.reshape(b, *stem_thw, -1).permute(0, 4, 1, 2, 3)
    up = F.interpolate(grid, size=thw, mode="trilinear", align_corners=False)
    feat = feat + up.permute(0, 2, 3, 4, 1).reshape(b, -1, up.shape[1])
    logits = conv3d(feat.reshape(b, *thw, -1), P["classifier.weight"], P["classifier.bias"], 1, 0,
                    rd)
    if not embed:
        return logits
    v_emb = linear(x_rw.mean(dim=1), P["vision_proj.weight"], P["vision_proj.bias"], rd)
    a_emb = linear(y_rw.mean(dim=1), P["audio_proj.weight"], P["audio_proj.bias"], rd)
    return logits, v_emb, a_emb


def frame_softmax(logits: torch.Tensor, temperature: float = 2.0) -> torch.Tensor:
    """Per-frame spatial softmax of (B, T, H, W, 1) logits at temperature 2."""
    b, t, h, w, c = logits.shape
    return torch.softmax(logits.reshape(b, t, h * w, c) / temperature, dim=2).reshape(logits.shape)


def mvit_params(a: MViTArch) -> Dict[str, tuple]:
    """{name: (shape, init)} of the MViT classifier (PySlowFast's names)."""
    e = a.embed
    t, h, w = a.patch_dims
    out = conv_params("patch_embed.proj", e, 3, a.patch_kernel)
    out.update({"cls_token": ((1, 1, e), "tn"), "pos_embed_spatial": ((1, h * w, e), "tn"),
                "pos_embed_temporal": ((1, t, e), "tn"), "pos_embed_class": ((1, 1, e), "tn")})
    for i, b in enumerate(a.blocks):
        out.update(block_params(f"blocks.{i}.", b))
    d = a.blocks[-1].dim_out
    out.update(norm_params("norm", d))
    out.update(linear_params("head.projection", a.classes, d))
    return out


def mvit_forward(P: Params, a: MViTArch, video: torch.Tensor, rd: Round = ident) -> torch.Tensor:
    """video (B, T, H, W, 3) -> (B, classes) logits at eval: patch embed, the
    cls token, position embeddings, the blocks, LN, the cls token's feature,
    the head's projection."""
    x = conv3d(video, P["patch_embed.proj.weight"], P["patch_embed.proj.bias"], a.patch_stride,
               a.patch_padding, rd)
    b = x.shape[0]
    x = torch.cat([P["cls_token"].expand(b, -1, -1), x.reshape(b, -1, x.shape[-1])], dim=1)
    x = x + torch.cat([P["pos_embed_class"], _pos(P, "", a.patch_dims)], dim=1)
    thw = a.patch_dims
    for i, blk in enumerate(a.blocks):
        x, thw = block(P, f"blocks.{i}.", blk, x, thw, rd=rd)
    x = layer_norm(x, P["norm.weight"], P["norm.bias"], 1e-6)
    return linear(x[:, 0], P["head.projection.weight"], P["head.projection.bias"], rd)

"""The MViT video classifier (``csts_tpu/models/mvit_classifier.py``): the
K400 MViT-B 16x4 whose checkpoint is the CSTS fine-tune init (README.md:110-114).

patch embed → cls token (optional) → separate or joint position embedding →
the multiscale blocks (cls-aware pooling) → LN → the cls token's feature or
the tokens' mean → head dropout (training) → the head. It returns logits;
MODEL.HEAD_ACT (softmax or sigmoid) is the caller's, as in the JAX package.

Module names follow PySlowFast's MViT (``patch_embed.proj``, ``cls_token``,
``pos_embed_spatial`` / ``pos_embed_temporal`` / ``pos_embed_class`` or
``pos_embed``, ``blocks.i.*``, ``norm``, ``head.projection``), so a state
dict in the reference's layout loads with ``strict=True``. Registered as
``MVIT`` in :data:`csts_torch.models.build.MODEL_REGISTRY`.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from csts_torch import ops
from csts_torch.config import Config
from csts_torch.models.build import MODEL_REGISTRY
from csts_torch.models.csts import PatchEmbed, init_params
from csts_torch.models.csts import build_spec as build_csts_spec
from csts_torch.models.mvit import THW, AttentionSpec, MultiScaleBlock
from csts_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class MViTSpec:
    """Static metadata of one classifier (field for field the JAX one)."""

    crop_size: int
    num_frames: int
    in_chans: int
    patch_kernel: Tuple[int, ...]
    patch_stride: Tuple[int, ...]
    patch_padding: Tuple[int, ...]
    embed_dim: int
    patch_dims: THW
    sep_pos_embed: bool
    cls_embed_on: bool
    blocks: Tuple[AttentionSpec, ...]
    num_classes: int
    head_dropout: float
    head_act: str
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def build_mvit_spec(cfg: Config) -> MViTSpec:
    """The CSTS derivation of the video blocks' trajectory
    (:func:`csts_torch.models.csts.build_spec`, run with CLS_EMBED_ON off,
    which it refuses), each block then tagged with the cls token."""
    cls_on = cfg.MVIT.CLS_EMBED_ON
    if cls_on:
        cfg = copy.deepcopy(cfg)
        cfg.MVIT.CLS_EMBED_ON = False
    base = build_csts_spec(cfg)
    return MViTSpec(
        crop_size=base.crop_size,
        num_frames=base.num_frames,
        in_chans=base.in_chans,
        patch_kernel=base.patch_kernel,
        patch_stride=base.patch_stride,
        patch_padding=base.patch_padding,
        embed_dim=base.embed_dim,
        patch_dims=base.patch_dims,
        sep_pos_embed=base.sep_pos_embed,
        cls_embed_on=cls_on,
        blocks=tuple(dataclasses.replace(b, has_cls=cls_on) for b in base.video_blocks),
        num_classes=cfg.MODEL.NUM_CLASSES,
        head_dropout=cfg.MODEL.DROPOUT_RATE,
        head_act=cfg.MODEL.HEAD_ACT,
        dtype=base.dtype,
    )


class Head(nn.Module):
    """PySlowFast's ``TransformerBasicHead``: the projection (dropout and the
    activation are applied by :class:`MViT` and its caller)."""

    def __init__(self, dim: int, num_classes: int):
        super().__init__()
        self.projection = nn.Linear(dim, num_classes)


class MViT(nn.Module):
    def __init__(self, spec: MViTSpec):
        super().__init__()
        self.spec = spec
        e = spec.embed_dim
        t, h, w = spec.patch_dims
        self.patch_embed = PatchEmbed(
            spec.in_chans, e, spec.patch_kernel, spec.patch_stride, spec.patch_padding)
        if spec.cls_embed_on:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, e))
        if spec.sep_pos_embed:
            self.pos_embed_spatial = nn.Parameter(torch.zeros(1, h * w, e))
            self.pos_embed_temporal = nn.Parameter(torch.zeros(1, t, e))
            if spec.cls_embed_on:
                self.pos_embed_class = nn.Parameter(torch.zeros(1, 1, e))
        else:
            self.pos_embed = nn.Parameter(torch.zeros(1, t * h * w + spec.cls_embed_on, e))
        self.blocks = nn.ModuleList(MultiScaleBlock(b) for b in spec.blocks)
        dim = spec.blocks[-1].dim_out
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = Head(dim, spec.num_classes)

    def _pos_embed(self) -> torch.Tensor:
        t, h, w = self.spec.patch_dims
        if not self.spec.sep_pos_embed:
            return self.pos_embed
        pe = (self.pos_embed_spatial.repeat(1, t, 1)
              + self.pos_embed_temporal.repeat_interleave(h * w, dim=1))
        if self.spec.cls_embed_on:
            pe = torch.cat([self.pos_embed_class, pe], dim=1)
        return pe

    def forward(self, video: torch.Tensor, drop=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """video: (B, T, H, W, C) -> (B, num_classes) logits, activations in
        ``spec.compute_dtype`` (JAX's ``mvit_apply``). In training
        (``module.train()``): ``drop``, one entry per block from
        ``ops.sample_drop_masks(spec.blocks, ...)`` (None: no stochastic
        depth), and the head's dropout mask drawn from ``generator`` (a CPU
        generator, so the mask does not depend on the device), required
        while MODEL.DROPOUT_RATE is above 0."""
        spec = self.spec
        cdt = spec.compute_dtype
        with tracing.span("csts.model.encoders"):
            x = self.patch_embed(video.to(cdt))
            b = x.shape[0]
            if spec.cls_embed_on:
                x = torch.cat([self.cls_token.to(cdt).expand(b, -1, -1), x], dim=1)
            x = x + self._pos_embed().to(cdt)
            if drop is None:
                drop = [None] * len(self.blocks)
            thw: THW = spec.patch_dims
            for blk, d in zip(self.blocks, drop):
                x, thw = blk(x, thw, drop=d)
        x = ops.layer_norm(x, self.norm.weight, self.norm.bias)
        feat = x[:, 0] if spec.cls_embed_on else x.mean(dim=1)
        if self.training and spec.head_dropout > 0:
            if generator is None:
                raise ValueError("the head's dropout needs a generator in training")
            keep = 1.0 - spec.head_dropout
            mask = (torch.rand(feat.shape, generator=generator) < keep).to(feat.device)
            feat = feat * mask.to(feat.dtype) / keep
        p = self.head.projection
        return ops.linear(feat, p.weight, p.bias)


def init_mvit_params(model: MViT, generator: torch.Generator) -> None:
    """Seeded random weights with the JAX ``mvit_init`` rules (those of
    :func:`csts_torch.models.csts.init_params`; the cls token zero)."""
    init_params(model, generator)
    if model.spec.cls_embed_on:
        with torch.no_grad():
            model.cls_token.zero_()


@MODEL_REGISTRY.register("MVIT")
def _build_mvit(cfg: Config) -> MViT:
    model = MViT(build_mvit_spec(cfg))
    init_mvit_params(model, torch.Generator().manual_seed(cfg.RNG_SEED))
    return model

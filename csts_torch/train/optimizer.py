"""Optimizer factory (``csts_tpu/train/optimizer.py``; reference
``slowfast/models/optimizer.py:11-130``), on ``torch.optim``.

Parameter-group rules, as the JAX package's ``weight_decay_mask``:

* no weight decay for rank ≤1 tensors and biases when SOLVER.ZERO_WD_1D_PARAM
  (every LayerNorm weight and bias, every linear and conv bias);
* no weight decay for the position embeddings, the audio branch's included,
  when MVIT.ZERO_DECAY_POS_CLS.

The update is the JAX package's optax chain: the global-norm clip with
optax's formula (grads · max/‖g‖ only when ‖g‖ > max, no ``+1e-6`` as
``torch.nn.utils.clip_grad_norm_`` adds) or the value clip, then AdamW with
betas (0.9, 0.999) and eps 1e-8 and decoupled decay from the same old
weights (``torch.optim.AdamW``: the same update as scale_by_adam →
add_decayed_weights → scale_by_learning_rate); "adam" is that same chain, as
in the JAX package; "sgd" folds the decay into the gradient before the
momentum trace (``torch.optim.SGD``). A parameter that the loss does not
reach gets a zero gradient, so it still decays, as under optax.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from csts_torch.config import Config

# the reference's no_weight_decay() names, and the audio branch's twins
POS_EMBED_NAMES = {
    "pos_embed_spatial", "pos_embed_temporal", "pos_embed_class", "pos_embed", "cls_token",
    "pos_embed_spatial_audio", "pos_embed_temporal_audio", "pos_embed_audio",
}


def weight_decay_mask(model: nn.Module, cfg: Config) -> Dict[str, bool]:
    """{parameter name: whether weight decay applies}."""
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if cfg.MVIT.ZERO_DECAY_POS_CLS and parts[0] in POS_EMBED_NAMES:
            out[name] = False
        elif cfg.SOLVER.ZERO_WD_1D_PARAM and (p.dim() <= 1 or parts[-1] in ("b", "bias")):
            out[name] = False
        else:
            out[name] = True
    return out


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ‖g‖²) over all gradients (optax.global_norm)."""
    return torch.nn.utils.get_total_norm(grads, norm_type=2.0)


class Optimizer:
    """The clip and the update of one training step, and the torch optimizer
    that keeps the moments. ``step(lr)`` returns the pre-clip global norm."""

    def __init__(self, opt: torch.optim.Optimizer, clip_norm: Optional[float],
                 clip_value: Optional[float]):
        self.opt = opt
        self.clip_norm = clip_norm
        self.clip_value = clip_value

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for group in self.opt.param_groups for p in group["params"]]

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self, lr: float) -> torch.Tensor:
        params = self.params
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        if self.clip_value:
            for g in grads:
                g.clamp_(-self.clip_value, self.clip_value)
        elif self.clip_norm:
            # optax: where(norm < max, g, g / norm · max), no host round-trip
            factor = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                 self.clip_norm / norm)
            torch._foreach_mul_(grads, factor)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        return norm


def construct_optimizer(model: nn.Module, cfg: Config) -> Optimizer:
    """The torch optimizer over two groups (decay, no decay), with the clip."""
    solver = cfg.SOLVER
    if solver.BF16_MOMENTS:
        raise NotImplementedError("SOLVER.BF16_MOMENTS is not ported yet")
    if solver.ZERO1 or solver.FSDP:
        raise NotImplementedError("SOLVER.ZERO1 / SOLVER.FSDP are not ported yet")
    mask = weight_decay_mask(model, cfg)
    named = dict(model.named_parameters())
    groups = [
        {"params": [p for n, p in named.items() if mask[n]], "weight_decay": solver.WEIGHT_DECAY},
        {"params": [p for n, p in named.items() if not mask[n]], "weight_decay": 0.0},
    ]
    groups = [g for g in groups if g["params"]]
    method = solver.OPTIMIZING_METHOD
    # one fused kernel for the update on CUDA (the same formula)
    fused = next(model.parameters()).device.type == "cuda"
    if method in ("adamw", "adam"):
        opt = torch.optim.AdamW(groups, lr=solver.BASE_LR, betas=(0.9, 0.999), eps=1e-8,
                                fused=fused)
    elif method == "sgd":
        opt = torch.optim.SGD(groups, lr=solver.BASE_LR, momentum=solver.MOMENTUM,
                              nesterov=solver.NESTEROV and solver.MOMENTUM > 0)
    else:
        raise NotImplementedError(f"Does not support {method} optimizer")
    return Optimizer(opt, solver.CLIP_GRAD_L2NORM, solver.CLIP_GRAD_VAL)

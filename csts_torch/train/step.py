"""The training and evaluation steps (``csts_tpu/train/step.py``).

One step at ``accum_steps = 1``: the model's training forward with
``return_embed`` and per-block stochastic-depth masks drawn from a
``torch.Generator``, the per-frame softmax at T = 2, the loss (kldiv +
LOSS_ALPHA·EgoNCE over the batch for ``kldiv+egonce``), backward, the clip
and the update (``train/optimizer.py``) at the cosine LR of
``step / steps_per_epoch``, and the fp32 EMA of the weights when
SOLVER.EMA_DECAY > 0. The JAX package compiles the step into one XLA
program; here PyTorch runs it eagerly, through the kernels on CUDA (K1 and
B8, B7, K3) and their plain twins on the CPU.

Entry points run on CUDA unless the caller names another device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from csts_torch import ops, resolve_device
from csts_torch.config import Config
from csts_torch.models.csts import CSTS, CSTSSpec, init_params
from csts_torch.train import losses
from csts_torch.train.lr_policy import get_lr_at_epoch
from csts_torch.train.optimizer import Optimizer, construct_optimizer


@dataclasses.dataclass
class TrainState:
    """The model (fp32 master weights, training mode), its optimizer, the
    step count and, with SOLVER.EMA_DECAY > 0, the fp32 EMA of the weights
    by parameter name."""

    model: CSTS
    optimizer: Optimizer
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None


def create_train_state(
    cfg: Config, spec: CSTSSpec, generator: Optional[torch.Generator] = None,
    state_dict: Optional[Mapping[str, torch.Tensor]] = None, device=None,
) -> TrainState:
    """A fresh state: weights from ``state_dict`` (strict) or seeded random
    ones from ``generator`` (``init_params``), fp32, on ``device`` (CUDA by
    default)."""
    device = resolve_device(device)
    model = CSTS(spec)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_params(model, generator if generator is not None else torch.Generator().manual_seed(0))
    model = model.float().to(device).train()
    ema = ({n: p.detach().float().clone() for n, p in model.named_parameters()}
           if cfg.SOLVER.EMA_DECAY > 0 else None)
    return TrainState(model, construct_optimizer(model, cfg), 0, ema)


def forward_loss(
    cfg: Config, model: CSTS, batch: Mapping[str, torch.Tensor], drop,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """The objective of ``make_train_step``'s ``loss_fn``: (loss, stats,
    preds). ``batch``: video (B,T,H,W,3), audio (B,T,F,S,1), labels_hm
    (B,T,h,w); ``drop``: per video block masks (``ops.sample_drop_masks``)."""
    loss_name = cfg.MODEL.LOSS_FUNC
    use_nce = "nce" in loss_name
    out = model(batch["video"], batch["audio"], return_embed=use_nce, drop=drop)
    logits, v_embed, a_embed = out if use_nce else (out, None, None)
    preds = losses.frame_softmax(logits, temperature=2.0)
    if loss_name in ("kldiv", "kldiv+egonce"):
        main = losses.kldiv_loss(preds, batch["labels_hm"])
    else:
        main = losses.get_loss_fn(loss_name)(logits, batch["labels_hm"])
    stats = {"kldiv_loss": main}
    loss = main
    if use_nce:
        nce = losses.egonce_loss(losses.sim_matrix(v_embed, a_embed))
        loss = loss + cfg.MODEL.LOSS_ALPHA * nce
        stats["egonce_loss"] = nce
    stats["loss"] = loss
    return loss, stats, preds


def make_train_step(cfg: Config, spec: CSTSSpec, steps_per_epoch: int,
                    accum_steps: int = 1) -> Callable:
    """Returns ``train_step(state, batch, generator, drop=None) -> (stats,
    preds)``, which updates ``state`` in place. The stochastic-depth masks
    are drawn from ``generator`` unless ``drop`` gives them (one entry per
    video block, as ``ops.sample_drop_masks`` returns). stats: loss,
    kldiv_loss, egonce_loss (with NCE), lr and grad_norm (the pre-clip global
    norm, as optax reports it), as 0-d tensors on the device except lr (a
    float)."""
    if accum_steps != 1:
        raise NotImplementedError(
            "gradient accumulation (the JAX package's GradCache two-pass) is not ported yet")
    ema_decay = cfg.SOLVER.EMA_DECAY

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                   generator: Optional[torch.Generator], drop=None):
        model = state.model
        lr = get_lr_at_epoch(cfg.SOLVER, state.step / steps_per_epoch)
        if drop is None:
            device = next(model.parameters()).device
            drop = ops.sample_drop_masks(spec, batch["video"].shape[0], generator, device)
        _, stats, preds = forward_loss(cfg, model, batch, drop)
        state.optimizer.zero_grad()
        stats["loss"].backward()
        grad_norm = state.optimizer.step(lr)
        state.step += 1
        if state.ema is not None:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    state.ema[name].mul_(ema_decay).add_(p.detach().float(), alpha=1.0 - ema_decay)
        stats = {k: v.detach() for k, v in stats.items()}
        stats.update(lr=lr, grad_norm=grad_norm)
        return stats, preds.detach()

    return train_step


def make_eval_step(cfg: Config, spec: CSTSSpec) -> Callable:
    """Returns ``eval_step(model, batch) -> per-frame heatmaps`` (the model's
    eval forward and the softmax at T = 2), leaving the model's mode as it was."""

    def eval_step(model: CSTS, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                logits = model(batch["video"], batch["audio"])
                return losses.frame_softmax(logits, temperature=2.0)
        finally:
            model.train(was_training)

    return eval_step


def check_nan_loss(loss: float, step: int) -> None:
    """Host-side NaN guard (misc.py:26-33)."""
    if math.isnan(loss):
        raise RuntimeError(f"ERROR: Got NaN losses at step {step}")

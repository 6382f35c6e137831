"""The training and evaluation steps (``csts_tpu/train/step.py``).

One step: the model's training forward with ``return_embed`` and per-block
stochastic-depth masks drawn from a ``torch.Generator``, the per-frame
softmax at T = 2, the loss (kldiv + LOSS_ALPHA·EgoNCE over the batch for
``kldiv+egonce``), backward, the clip and the update
(``train/optimizer.py``) at the cosine LR of ``step / steps_per_epoch``, and
the fp32 EMA of the weights when SOLVER.EMA_DECAY > 0. The JAX package
compiles the step into one XLA program; here PyTorch runs it eagerly,
through the kernels on CUDA (K1 and B8, B7, K3; B5 under TRAIN_DECODER)
and their plain twins on the CPU, on the routes the JAX package's switches
in ``kernels/attention.py`` choose (``models/mvit.py`` ``train_route``).

``accum_steps > 1`` splits the batch into micro-batches before the one
update. With EgoNCE in the loss it is the GradCache two-pass, so the
contrastive negatives stay those of the whole batch: pass A runs every
micro-batch forward without grad and keeps the embeddings, EgoNCE and its
embedding gradients are computed once over all of them, and pass B replays
each micro-batch with the same masks and back-propagates (kldiv, v_embed,
a_embed) with (1/accum, α·dV_i, α·dA_i). Without EgoNCE the micro-batches'
gradients are averaged. MODEL.ACT_CHECKPOINT recomputes each encoder
block's activations in the backward (``models/csts.py``).

With a process group each rank steps on its stripe of the global batch
through ``TrainState.net`` (DDP, or the FSDP-sharded model), and W ranks
compute what one process computes at the global batch: EgoNCE's similarity
is taken over every rank's embeddings (``collectives.all_gather_with_grad``;
GradCache's pass A gathers them the same way), the stochastic-depth masks
are drawn for the global batch from the same generator on every rank and
each keeps its rows, DDP's mean of the gradients gives the one-process
mean, and the reported losses are the global batch's. Every micro-batch
backward but the last skips the gradient reduction.

Entry points run on CUDA unless the caller names another device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.distributed.fsdp import FSDPModule

from csts_torch import ops, resolve_device
from csts_torch.config import Config
from csts_torch.models.csts import CSTS, CSTSSpec, init_params
from csts_torch.parallel import collectives, mesh
from csts_torch.train import losses
from csts_torch.train.lr_policy import get_lr_at_epoch
from csts_torch.train.optimizer import Optimizer, construct_optimizer


@dataclasses.dataclass
class TrainState:
    """The model (fp32 master weights, training mode), its optimizer, the
    step count and, with SOLVER.EMA_DECAY > 0, the fp32 EMA of the weights
    by parameter name. ``net`` is the module the step calls: with a process
    group DDP around ``model`` (or ``model`` itself, sharded by FSDP), else
    ``model``."""

    model: CSTS
    optimizer: Optimizer
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None
    net: Optional[nn.Module] = None


def create_train_state(
    cfg: Config, spec: CSTSSpec, generator: Optional[torch.Generator] = None,
    state_dict: Optional[Mapping[str, torch.Tensor]] = None, device=None,
) -> TrainState:
    """A fresh state: weights from ``state_dict`` (strict) or seeded random
    ones from ``generator`` (``init_params``), fp32, on ``device`` (CUDA by
    default), wrapped for the process group if one is started
    (``mesh.wrap_for_training``)."""
    device = resolve_device(device)
    model = CSTS(spec)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_params(model, generator if generator is not None else torch.Generator().manual_seed(0))
    model = model.float().to(device).train()
    net = mesh.wrap_for_training(model, cfg)
    ema = ({n: _ema_like(p) for n, p in model.named_parameters()}
           if cfg.SOLVER.EMA_DECAY > 0 else None)
    return TrainState(model, construct_optimizer(model, cfg), 0, ema, net)


def _ema_like(p: torch.Tensor) -> torch.Tensor:
    """An fp32 copy of ``p`` for the EMA, split as ``p`` is on the model axis."""
    t = p.detach().float().clone()
    if getattr(p, "model_split", None) is not None:
        t.model_split = p.model_split
    return t


def _main_loss(cfg: Config, logits: torch.Tensor, preds: torch.Tensor,
               labels_hm: torch.Tensor) -> torch.Tensor:
    """The loss besides EgoNCE; kldiv+egonce's kldiv is assembled here."""
    if cfg.MODEL.LOSS_FUNC in ("kldiv", "kldiv+egonce"):
        return losses.kldiv_loss(preds, labels_hm)
    return losses.get_loss_fn(cfg.MODEL.LOSS_FUNC)(logits, labels_hm)


def forward_loss(
    cfg: Config, model: CSTS, batch: Mapping[str, torch.Tensor], drop,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
    """The objective of ``make_train_step``'s ``loss_fn``: (loss, stats,
    preds). ``batch``: video (B,T,H,W,3), audio (B,T,F,S,1), labels_hm
    (B,T,h,w); ``drop``: per video block masks (``ops.sample_drop_masks``).
    With a process group, ``batch`` is this rank's stripe, the main loss
    its mean, and EgoNCE the global batch's."""
    use_nce = "nce" in cfg.MODEL.LOSS_FUNC
    out = model(batch["video"], batch["audio"], return_embed=use_nce, drop=drop)
    logits, v_embed, a_embed = out if use_nce else (out, None, None)
    preds = losses.frame_softmax(logits, temperature=2.0)
    main = _main_loss(cfg, logits, preds, batch["labels_hm"])
    stats = {"kldiv_loss": main}
    loss = main
    if use_nce:
        nce = losses.egonce_loss(losses.sim_matrix(collectives.all_gather_with_grad(v_embed),
                                                   collectives.all_gather_with_grad(a_embed)))
        loss = loss + cfg.MODEL.LOSS_ALPHA * nce
        stats["egonce_loss"] = nce
    stats["loss"] = loss
    return loss, stats, preds


def _micro(batch: Mapping[str, torch.Tensor], accum: int, i: int) -> Dict[str, torch.Tensor]:
    """Micro-batch ``i`` of ``accum``: rows [i·B/accum, (i+1)·B/accum)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // accum
        out[k] = v[i * n:(i + 1) * n]
    return out


def _reduce_grads(net: nn.Module, last: bool):
    """The context of one micro-batch's forward and backward: the gradient
    reduction runs on the last only (DDP's ``no_sync``; FSDP2's flag)."""
    if isinstance(net, nn.parallel.DistributedDataParallel):
        return contextlib.nullcontext() if last else net.no_sync()
    if hasattr(net, "set_requires_gradient_sync"):  # FSDP2
        net.set_requires_gradient_sync(last)
    return contextlib.nullcontext()


def _grad_cache(cfg: Config, model: nn.Module, batch, drops, accum: int):
    """The GradCache two-pass over ``accum`` micro-batches (EgoNCE in the
    loss); accumulates the gradients into ``.grad``, returns (stats, preds).
    With a process group pass A gathers every rank's embeddings, so the
    negatives are the global batch's."""
    alpha = cfg.MODEL.LOSS_ALPHA
    micro = [_micro(batch, accum, i) for i in range(accum)]
    # pass A: every micro-batch's embeddings, no graph kept; the model stays
    # in training mode, so this is pass B's route (B5's under TRAIN_DECODER
    # too), kernels and masks
    with torch.no_grad():
        embeds = [model(mb["video"], mb["audio"], return_embed=True, drop=d)[1:]
                  for mb, d in zip(micro, drops)]
        v_loc = torch.cat([v for v, _ in embeds])
        a_loc = torch.cat([a for _, a in embeds])
        v_all = collectives.all_gather_with_grad(v_loc).detach().requires_grad_()
        a_all = collectives.all_gather_with_grad(a_loc).detach().requires_grad_()
    with torch.enable_grad():
        nce = losses.egonce_loss(losses.sim_matrix(v_all, a_all))
    dv, da = torch.autograd.grad(nce, (v_all, a_all))
    # this rank's rows of the ranks' summed embedding gradients, as
    # all_gather_with_grad's backward gives them (DDP's mean divides by W)
    lo, rows = collectives.rank() * v_loc.shape[0], v_loc.shape[0]
    dv = collectives.all_reduce_sum(dv)[lo:lo + rows]
    da = collectives.all_reduce_sum(da)[lo:lo + rows]
    del embeds, v_all, a_all, v_loc, a_loc
    kls, preds = [], []
    for i, (mb, d) in enumerate(zip(micro, drops)):
        with _reduce_grads(model, i == accum - 1):
            logits, v, a = model(mb["video"], mb["audio"], return_embed=True, drop=d)
            p = losses.frame_softmax(logits, temperature=2.0)
            kl = _main_loss(cfg, logits, p, mb["labels_hm"])
            n = v.shape[0]
            torch.autograd.backward(
                (kl, v, a),
                (torch.full_like(kl, 1.0 / accum), (alpha * dv[i * n:(i + 1) * n]).to(v.dtype),
                 (alpha * da[i * n:(i + 1) * n]).to(a.dtype)))
        kls.append(kl.detach())
        preds.append(p.detach())
    kl_mean = torch.stack(kls).mean()
    nce = nce.detach()
    stats = {"kldiv_loss": kl_mean, "egonce_loss": nce, "loss": kl_mean + alpha * nce}
    return stats, torch.cat(preds)


def _grad_mean(cfg: Config, model: nn.Module, batch, drops, accum: int):
    """The micro-batches' mean gradient (no EgoNCE); returns (stats, preds)."""
    sums: Dict[str, torch.Tensor] = {}
    preds = []
    for i, d in enumerate(drops):
        with _reduce_grads(model, i == accum - 1):
            loss, stats_i, p = forward_loss(cfg, model, _micro(batch, accum, i), d)
            (loss / accum).backward()
        for k, v in stats_i.items():
            sums[k] = sums.get(k, 0.0) + v.detach()
        preds.append(p.detach())
    return {k: v / accum for k, v in sums.items()}, torch.cat(preds)


Masks = List[Optional[Tuple[torch.Tensor, torch.Tensor]]]


def _local_masks(drops: List[Masks], lo: int, rows: int, accum: int) -> List[Masks]:
    """The global batch's masks (one set a micro-batch of the global batch,
    in order) -> this rank's rows ``[lo, lo + rows)``, one set a micro-batch
    of its stripe."""
    out: List[Masks] = [[] for _ in range(accum)]
    n = rows // accum
    for b, first in enumerate(drops[0]):
        if first is None:
            for o in out:
                o.append(None)
            continue
        whole = [torch.cat([d[b][k] for d in drops])[lo:lo + rows] for k in range(2)]
        for i, o in enumerate(out):
            o.append(tuple(m[i * n:(i + 1) * n] for m in whole))
    return out


def make_train_step(cfg: Config, spec: CSTSSpec, steps_per_epoch: int,
                    accum_steps: int = 1) -> Callable:
    """Returns ``train_step(state, batch, generator, drop=None) -> (stats,
    preds)``, which updates ``state`` in place. The stochastic-depth masks
    are drawn from ``generator`` (one set a micro-batch of the global batch,
    in order) unless ``drop`` gives them: one entry per video block, as
    ``ops.sample_drop_masks`` returns for the global batch, or with
    ``accum_steps > 1`` a list of such, one a micro-batch; each rank keeps
    its rows. stats: loss, kldiv_loss, egonce_loss (with NCE) of the global
    batch, lr and grad_norm (the pre-clip global norm, as optax reports it),
    as 0-d tensors on the device except lr (a float); preds are the rank's
    rows."""
    ema_decay = cfg.SOLVER.EMA_DECAY
    use_nce = "nce" in cfg.MODEL.LOSS_FUNC

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                   generator: Optional[torch.Generator], drop=None):
        net = state.net if state.net is not None else state.model
        lr = get_lr_at_epoch(cfg.SOLVER, state.step / steps_per_epoch)
        world = collectives.world_size()
        rows = batch["video"].shape[0]
        if rows % accum_steps:
            raise ValueError(f"batch of {rows} does not split into {accum_steps} micro-batches")
        if drop is None:
            device = next(state.model.parameters()).device
            drop = [ops.sample_drop_masks(spec.video_blocks, rows * world // accum_steps,
                                          generator, device)
                    for _ in range(accum_steps)]
        elif accum_steps == 1:
            drop = [drop]
        if world > 1:
            drop = _local_masks(drop, collectives.rank() * rows, rows, accum_steps)
        state.optimizer.zero_grad()
        if accum_steps == 1:
            _, stats, preds = forward_loss(cfg, net, batch, drop[0])
            stats["loss"].backward()
        elif use_nce:
            stats, preds = _grad_cache(cfg, net, batch, drop, accum_steps)
        else:
            stats, preds = _grad_mean(cfg, net, batch, drop, accum_steps)
        mesh.sync_grads()  # the model axes' gradients computed in part
        grad_norm = state.optimizer.step(lr)
        state.step += 1
        if state.ema is not None:
            with torch.no_grad():
                for name, p in state.model.named_parameters():
                    state.ema[name].mul_(ema_decay).add_(p.detach().float(), alpha=1.0 - ema_decay)
        stats = {k: v.detach() for k, v in stats.items()}
        if world > 1:  # the ranks' mean of the main loss; EgoNCE is already global
            stats["kldiv_loss"] = collectives.all_reduce_sum(stats["kldiv_loss"]) / world
            stats["loss"] = stats["kldiv_loss"] + (cfg.MODEL.LOSS_ALPHA * stats["egonce_loss"]
                                                   if use_nce else 0.0)
        stats.update(lr=lr, grad_norm=grad_norm)
        return stats, preds.detach()

    return train_step


def make_eval_step(cfg: Config, spec: CSTSSpec) -> Callable:
    """Returns ``eval_step(model, batch) -> per-frame heatmaps`` (the model's
    eval forward and the softmax at T = 2), leaving the model's mode as it
    was and an FSDP model's parameters sharded, as they were."""

    def eval_step(model: CSTS, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                logits = model(batch["video"], batch["audio"])
                return losses.frame_softmax(logits, temperature=2.0)
        finally:
            model.train(was_training)
            if isinstance(model, FSDPModule):
                # the root keeps the parameters it gathered (inference
                # tensors here) registered after a forward
                model.reshard()

    return eval_step


def check_nan_loss(loss: float, step: int) -> None:
    """Host-side NaN guard (misc.py:26-33)."""
    if math.isnan(loss):
        raise RuntimeError(f"ERROR: Got NaN losses at step {step}")

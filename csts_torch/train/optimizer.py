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

SOLVER.BF16_MOMENTS is optax's ``mu_dtype=bfloat16``: the first moment is
stored in bf16 and each update runs on its fp32 value (``AdamWBF16Mu``, a
foreach update of the same formula, since ``torch.optim.AdamW`` keeps the
moments in the parameters' dtype); the second moment stays fp32.

:class:`Optimizer` also reads and writes the moments and counts by parameter
name (``moments``, ``load_moments``), which the npz checkpoints of
``utils/checkpoint.py`` hold in the JAX package's layout.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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


BETAS = (0.9, 0.999)
EPS = 1e-8
_B1_BF16 = float(torch.tensor(BETAS[0], dtype=torch.bfloat16))


class AdamWBF16Mu(torch.optim.Optimizer):
    """AdamW with the first moment stored in bf16 (SOLVER.BF16_MOMENTS):
    torch's AdamW formula, each step on an fp32 first moment formed as optax
    forms it (b1·mu in bf16 with b1 rounded to bf16, plus (1 - b1)·g in
    fp32), which is then rounded to bf16 for storage; the second moment is
    fp32. State per parameter as ``torch.optim.AdamW`` keeps it: step (a
    float tensor), exp_avg (bf16), exp_avg_sq."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, {"lr": lr, "weight_decay": weight_decay})

    @torch.no_grad()
    def step(self, closure=None):
        b1, b2 = BETAS
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                state["step"] += 1
            grads = [p.grad.float() for p in params]
            mus = [self.state[p]["exp_avg"] for p in params]
            nus = [self.state[p]["exp_avg_sq"] for p in params]
            step = float(self.state[params[0]]["step"])
            lr, wd = group["lr"], group["weight_decay"]
            if wd:
                torch._foreach_mul_(params, 1.0 - lr * wd)
            # optax's update_moment: b1·mu in mu's dtype, b1 itself rounded to
            # bf16 first (0.8984375: JAX casts the Python scalar to the array's
            # dtype), plus (1 - b1)·g in fp32
            mu32 = [m.float() for m in torch._foreach_mul(mus, _B1_BF16)]
            torch._foreach_add_(mu32, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, 1.0 - b2)
            bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            denom = torch._foreach_sqrt(nus)
            torch._foreach_div_(denom, bc2 ** 0.5)
            torch._foreach_add_(denom, EPS)
            torch._foreach_addcdiv_(params, mu32, denom, -lr / bc1)
            for m, m32 in zip(mus, mu32):
                m.copy_(m32)


class Optimizer:
    """The clip and the update of one training step, and the torch optimizer
    that keeps the moments. ``step(lr)`` returns the pre-clip global norm.
    ``named`` gives each parameter its name, by which the moments are read
    and written."""

    def __init__(self, opt: torch.optim.Optimizer, clip_norm: Optional[float],
                 clip_value: Optional[float], method: str = "adamw",
                 named: Optional[Dict[str, torch.Tensor]] = None):
        self.opt = opt
        self.clip_norm = clip_norm
        self.clip_value = clip_value
        self.method = method
        self.named = dict(named or {})

    @property
    def lr(self) -> float:
        """The learning rate last set."""
        return float(self.opt.param_groups[0]["lr"])

    def moments(self) -> Tuple[int, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(count, first, second) by parameter name. AdamW/Adam: the steps
        taken, exp_avg and exp_avg_sq; SGD: 0, the momentum buffers and {}.
        A moment not made yet (no step taken) reads as zeros, in bf16 for
        AdamW's first moment under SOLVER.BF16_MOMENTS."""
        first, second, count = {}, {}, 0
        bf16_mu = isinstance(self.opt, AdamWBF16Mu)
        for name, p in self.named.items():
            state = self.opt.state.get(p, {})
            if self.method == "sgd":
                buf = state.get("momentum_buffer")
                first[name] = buf if buf is not None else torch.zeros_like(p)
                continue
            if "step" in state:
                count = int(state["step"])
                first[name], second[name] = state["exp_avg"], state["exp_avg_sq"]
            else:
                first[name] = torch.zeros_like(p, dtype=torch.bfloat16 if bf16_mu else p.dtype)
                second[name] = torch.zeros_like(p)
        return count, first, second

    def load_moments(self, count: int, first: Dict[str, torch.Tensor],
                     second: Dict[str, torch.Tensor]) -> None:
        """Sets the state :meth:`moments` reads, copied into tensors of each
        parameter's shape, layout and device, in the state's dtype."""
        bf16_mu = isinstance(self.opt, AdamWBF16Mu)
        fused = bool(self.opt.defaults.get("fused"))
        for name, p in self.named.items():
            state = self.opt.state[p]
            if self.method == "sgd":
                if self.opt.defaults.get("momentum", 0.0):
                    state["momentum_buffer"] = torch.empty_like(p).copy_(first[name])
                continue
            # fused AdamW keeps its step on the parameter's device
            state["step"] = torch.tensor(float(count), dtype=torch.float32,
                                         device=p.device if fused else "cpu")
            state["exp_avg"] = torch.empty_like(
                p, dtype=torch.bfloat16 if bf16_mu else p.dtype).copy_(first[name])
            state["exp_avg_sq"] = torch.empty_like(p).copy_(second[name])

    def set_lr(self, lr: float) -> None:
        for group in self.opt.param_groups:
            group["lr"] = lr

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
        self.set_lr(lr)
        self.opt.step()
        return norm


def construct_optimizer(model: nn.Module, cfg: Config) -> Optimizer:
    """The torch optimizer over two groups (decay, no decay), with the clip."""
    solver = cfg.SOLVER
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
    if method in ("adamw", "adam") and solver.BF16_MOMENTS:
        opt = AdamWBF16Mu(groups, lr=solver.BASE_LR)
    elif method in ("adamw", "adam"):
        opt = torch.optim.AdamW(groups, lr=solver.BASE_LR, betas=BETAS, eps=EPS, fused=fused)
    elif method == "sgd":
        opt = torch.optim.SGD(groups, lr=solver.BASE_LR, momentum=solver.MOMENTUM,
                              nesterov=solver.NESTEROV and solver.MOMENTUM > 0)
    else:
        raise NotImplementedError(f"Does not support {method} optimizer")
    return Optimizer(opt, solver.CLIP_GRAD_L2NORM, solver.CLIP_GRAD_VAL, method, named)

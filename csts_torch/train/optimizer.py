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

With a process group (``parallel/mesh.py``): SOLVER.ZERO1 is
``ZeroRedundancyOptimizer`` over the same torch optimizer and groups (each
rank updates and keeps the moments of its share of the parameters, then
broadcasts them; DDP has already averaged the whole gradients, so the norm
and the clip are those of one process). Under SOLVER.FSDP the parameters,
gradients and moments are FSDP2's DTensors, sharded over the ranks: the
norm adds the ranks' sums of squares, and ``moments`` / ``load_moments``
gather and scatter whole tensors. Without a group both are the one-process
optimizer: one rank holds every shard.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.distributed.optim import ZeroRedundancyOptimizer

from csts_torch.config import Config
from csts_torch.parallel import collectives, mesh

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


def global_norm(grads: List[torch.Tensor], params: Optional[List[torch.Tensor]] = None
                ) -> torch.Tensor:
    """sqrt(Σ‖g‖²) over all gradients (optax.global_norm); the shards of
    FSDP's DTensor gradients add their squares over the data axis, and the
    parts of the model axis's split (the parameters ``mesh`` marks
    ``model_split``) over the model axis."""
    from csts_torch.parallel import mesh

    split = [getattr(p, "model_split", None) is not None for p in params or []]
    split += [False] * (len(grads) - len(split))
    sq = {}  # (sharded over data, split over model) -> the local sum of squares
    for g, sp in zip(grads, split):
        key = (isinstance(g, collectives.DTensor), sp)
        sq.setdefault(key, []).append(collectives.local(g))
    if list(sq) == [(False, False)]:  # one process or whole parameters
        return torch.nn.utils.get_total_norm(grads, norm_type=2.0)
    total = None
    for (sharded, sp), gs in sorted(sq.items()):
        part = torch.nn.utils.get_total_norm(gs, norm_type=2.0) ** 2
        if sharded:
            part = collectives.all_reduce_sum(part)
        if sp:
            part = mesh.all_reduce(part, mesh.MODEL_AXIS)
        total = part if total is None else total + part
    return total.sqrt()


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
        # the torch optimizer that keeps this rank's moments (ZeRO-1's share)
        self.local = opt.optim if isinstance(opt, ZeroRedundancyOptimizer) else opt

    @property
    def lr(self) -> float:
        """The learning rate last set."""
        return float(self.opt.param_groups[0]["lr"])

    def _states(self) -> Optional[Dict[str, dict]]:
        """Each parameter's optimizer state by name (a model-axis part's
        state still split); under ZeRO-1 on the ranks of data index 0 only
        (None elsewhere): every rank calls it, and each parameter's moments
        come from the data rank that keeps them as tensor broadcasts over
        the data group (ZeroRedundancyOptimizer's own consolidation pickles
        every rank's state through the group). Each model-axis coordinate
        has such a rank, so the parts can be gathered whole there."""
        if not isinstance(self.opt, ZeroRedundancyOptimizer):
            return {name: self.opt.state.get(p, {}) for name, p in self.named.items()}
        params = self.params
        owned = {id(p) for group in self.local.param_groups for p in group["params"]}
        # per kept parameter: its tensors' (shape, dtype) and the scalars
        mine = {i: {k: (tuple(v.shape), v.dtype) if torch.is_tensor(v) and v.dim() else
                    (float(v) if torch.is_tensor(v) else v)
                    for k, v in self.local.state.get(p, {}).items()}
                for i, p in enumerate(params) if id(p) in owned}
        meta = {}
        for r, part in enumerate(collectives.gather_objects(mine)):
            meta.update({i: (r, m) for i, m in part.items()})
        keeper = collectives.rank() == 0
        states = []
        for i, p in enumerate(params):
            r, m = meta[i]
            state = {}
            for k, v in m.items():
                if not isinstance(v, tuple):
                    state[k] = torch.tensor(v)
                    continue
                buf = (self.local.state[p][k] if r == collectives.rank()
                       else torch.empty(v[0], dtype=v[1], device=p.device))
                torch.distributed.broadcast(buf, group=collectives.data_group(), group_src=r)
                state[k] = buf
            if keeper:
                states.append(state)
        if not keeper:
            return None
        by_param = {id(p): st for p, st in zip(params, states)}
        return {name: by_param[id(p)] for name, p in self.named.items()}

    def moments(self) -> Optional[Tuple[int, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
        """(count, first, second) by parameter name, whole tensors. AdamW/Adam:
        the steps taken, exp_avg and exp_avg_sq; SGD: 0, the momentum
        buffers and {}. A moment not made yet (no step taken) reads as
        zeros, in bf16 for AdamW's first moment under SOLVER.BF16_MOMENTS.
        Every rank calls it (the shards are gathered); under ZeRO-1 the
        ranks other than 0 get None."""
        states = self._states()
        if states is None:
            return None
        first, second, count = {}, {}, 0
        bf16_mu = isinstance(self.local, AdamWBF16Mu)
        for name, p in self.named.items():
            state = {k: collectives.whole(v, like=p) if torch.is_tensor(v) and v.dim() else v
                     for k, v in states[name].items()}
            zeros = lambda dtype=p.dtype: torch.zeros(mesh.whole_shape(p), dtype=dtype)  # noqa: E731
            if self.method == "sgd":
                buf = state.get("momentum_buffer")
                first[name] = buf if buf is not None else zeros()
                continue
            if "step" in state:
                count = int(state["step"])
                first[name], second[name] = state["exp_avg"], state["exp_avg_sq"]
            else:
                first[name] = zeros(torch.bfloat16 if bf16_mu else p.dtype)
                second[name] = zeros()
        if isinstance(self.opt, ZeroRedundancyOptimizer) and not collectives.is_master_proc():
            return None  # a data rank 0 at another place on the model, seq or pipe axis
        return count, first, second

    def load_moments(self, count: int, first: Dict[str, torch.Tensor],
                     second: Dict[str, torch.Tensor]) -> None:
        """Sets the state :meth:`moments` reads (whole tensors by name),
        copied into tensors of each parameter's shape, layout and device, in
        the state's dtype: under ZeRO-1 the moments of this rank's share,
        under FSDP this rank's shard of each."""
        bf16_mu = isinstance(self.local, AdamWBF16Mu)
        fused = bool(self.local.defaults.get("fused"))
        owned = {id(p) for group in self.local.param_groups for p in group["params"]}

        def like(p, value, dtype=None):
            return collectives.shard_like(p, value.to(dtype or p.dtype))

        for name, p in self.named.items():
            if id(p) not in owned:
                continue
            state = self.local.state[p]
            if self.method == "sgd":
                if self.local.defaults.get("momentum", 0.0):
                    state["momentum_buffer"] = like(p, first[name])
                continue
            # fused AdamW keeps its step on the parameter's device
            state["step"] = torch.tensor(float(count), dtype=torch.float32,
                                         device=p.device if fused else "cpu")
            state["exp_avg"] = like(p, first[name], torch.bfloat16 if bf16_mu else None)
            state["exp_avg_sq"] = like(p, second[name])

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
        norm = global_norm(grads, params)
        grads = [collectives.local(g) for g in grads]  # FSDP: each rank clips its shards
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
    """The torch optimizer over two groups (decay, no decay), with the clip;
    under SOLVER.ZERO1 with a process group, sharded by
    ``ZeroRedundancyOptimizer``."""
    solver = cfg.SOLVER
    mask = weight_decay_mask(model, cfg)
    named = dict(model.named_parameters())
    groups = [
        {"params": [p for n, p in named.items() if mask[n]], "weight_decay": solver.WEIGHT_DECAY},
        {"params": [p for n, p in named.items() if not mask[n]], "weight_decay": 0.0},
    ]
    groups = [g for g in groups if g["params"]]
    method = solver.OPTIMIZING_METHOD
    # one fused kernel for the update on CUDA (the same formula); FSDP's
    # DTensor moments take the foreach update
    fused = (next(model.parameters()).device.type == "cuda"
             and not isinstance(next(model.parameters()), collectives.DTensor))
    if method in ("adamw", "adam") and solver.BF16_MOMENTS:
        cls, kwargs = AdamWBF16Mu, {"lr": solver.BASE_LR}
    elif method in ("adamw", "adam"):
        cls, kwargs = torch.optim.AdamW, {"lr": solver.BASE_LR, "betas": BETAS, "eps": EPS,
                                          "fused": fused}
    elif method == "sgd":
        cls, kwargs = torch.optim.SGD, {"lr": solver.BASE_LR, "momentum": solver.MOMENTUM,
                                        "nesterov": solver.NESTEROV and solver.MOMENTUM > 0}
    else:
        raise NotImplementedError(f"Does not support {method} optimizer")
    if solver.ZERO1 and collectives.initialized():
        opt = ZeroRedundancyOptimizer(groups, optimizer_class=cls,
                                      process_group=collectives.data_group(), **kwargs)
    else:
        opt = cls(groups, **kwargs)
    return Optimizer(opt, solver.CLIP_GRAD_L2NORM, solver.CLIP_GRAD_VAL, method, named)

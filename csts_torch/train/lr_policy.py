"""Learning-rate schedules (``csts_tpu/train/lr_policy.py``; reference
``slowfast/utils/lr_policy.py:9-94``): plain functions of (cfg.SOLVER,
fractional epoch) returning a Python float, set on the optimizer before each
update."""

from __future__ import annotations

import math

from csts_torch.config import SolverConfig


def lr_func_cosine(solver: SolverConfig, cur_epoch: float) -> float:
    offset = solver.WARMUP_EPOCHS if solver.COSINE_AFTER_WARMUP else 0.0
    assert solver.COSINE_END_LR < solver.BASE_LR
    return (
        solver.COSINE_END_LR
        + (solver.BASE_LR - solver.COSINE_END_LR)
        * (math.cos(math.pi * (cur_epoch - offset) / (solver.MAX_EPOCH - offset)) + 1.0)
        * 0.5
    )


def lr_func_steps_with_relative_lrs(solver: SolverConfig, cur_epoch: float) -> float:
    # the JAX package's piecewise select, step by step
    steps = list(solver.STEPS) + [solver.MAX_EPOCH]
    lr = solver.LRS[0] * solver.BASE_LR
    for ind in range(len(steps) - 1):
        if cur_epoch >= steps[ind]:
            lr = solver.LRS[min(ind, len(solver.LRS) - 1)] * solver.BASE_LR
    return lr


_POLICIES = {
    "cosine": lr_func_cosine,
    "steps_with_relative_lrs": lr_func_steps_with_relative_lrs,
}


def get_lr_at_epoch(solver: SolverConfig, cur_epoch: float) -> float:
    """LR with linear warmup (lr_policy.py:9-27)."""
    if solver.LR_POLICY not in _POLICIES:
        raise NotImplementedError(f"Unknown LR policy: {solver.LR_POLICY}")
    policy = _POLICIES[solver.LR_POLICY]
    lr = policy(solver, cur_epoch)
    if solver.WARMUP_EPOCHS > 0 and cur_epoch < solver.WARMUP_EPOCHS:
        lr_start = solver.WARMUP_START_LR
        lr_end = policy(solver, solver.WARMUP_EPOCHS)
        lr = cur_epoch * (lr_end - lr_start) / solver.WARMUP_EPOCHS + lr_start
    return lr

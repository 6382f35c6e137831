"""BatchNorm helpers (``csts_tpu/models/batchnorm.py``; reference
``slowfast/models/batchnorm_helper.py:15-218`` and ``bn_helper.py:11-77``).

MViT and CSTS are LayerNorm-only; the BN family serves the conv models of the
PySlowFast lineage. As in the JAX package the functions take their state in
and return it, mutating nothing:

* :func:`batch_norm`: BatchNorm3d on channels-last grids with explicit
  running statistics; with ``sync`` the batch statistics are averaged over
  the ranks of a process group by ``torch.distributed.nn.functional.all_reduce``
  (differentiable, as JAX's ``lax.pmean``; the reference's
  ``NaiveSyncBatchNorm3d`` all-gathers by hand);
* :class:`SubBatchNorm`: split statistics in training, aggregated for eval;
* :func:`sub_to_normal_bn_state` / :func:`normal_to_sub_bn_state`: the
  checkpoint layouts;
* :func:`update_precise_stats`: precise BN over a number of batches.

A state is a dict of tensors ``{"mean", "var"}``; a tree is nested dicts and
lists of them.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def bn_init(dim: int, dtype=torch.float32) -> dict:
    return {"scale": torch.ones(dim, dtype=dtype), "bias": torch.zeros(dim, dtype=dtype)}


def bn_state_init(dim: int, dtype=torch.float32) -> dict:
    return {"mean": torch.zeros(dim, dtype=dtype), "var": torch.ones(dim, dtype=dtype)}


def _group_mean(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=group or dist.group.WORLD) / dist.get_world_size(group)


def batch_norm(
    params: dict,
    state: dict,
    x: torch.Tensor,
    *,
    training: bool,
    momentum: float = 0.1,
    eps: float = 1e-5,
    sync: bool = False,
    group=None,
) -> Tuple[torch.Tensor, dict]:
    """BatchNorm over every axis but the last (channels-last). ``sync``:
    the statistics are averaged over the ranks of ``group`` (the default
    group when None), the global batch's for equal stripes. Returns
    (normalised, new state); the running variance is the biased one, as
    in the JAX package."""
    reduce_axes = tuple(range(x.dim() - 1))
    if training:
        mean = x.mean(dim=reduce_axes)
        mean_sq = x.square().mean(dim=reduce_axes)
        if sync:
            mean = _group_mean(mean, group)
            mean_sq = _group_mean(mean_sq, group)
        var = mean_sq - mean.square()
        new_state = {
            "mean": (1 - momentum) * state["mean"] + momentum * mean,
            "var": (1 - momentum) * state["var"] + momentum * var,
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    out = (x - mean) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return out, new_state


class SubBatchNorm:
    """Split-statistics BN: in training the batch is normalised in
    ``num_splits`` independent groups; :meth:`aggregate_stats` folds the
    splits' running statistics into the global ones for eval
    (batchnorm_helper.py:37-109)."""

    def __init__(self, num_splits: int, dim: int):
        self.num_splits = num_splits
        self.dim = dim

    def init(self, dtype=torch.float32) -> Tuple[dict, dict]:
        params = bn_init(self.dim, dtype)
        state = {"split": bn_state_init(self.dim * self.num_splits, dtype),
                 "global": bn_state_init(self.dim, dtype)}
        return params, state

    def apply(self, params, state, x, *, training: bool, momentum=0.1, eps=1e-5):
        if not training:
            out, _ = batch_norm(params, state["global"], x, training=False, eps=eps)
            return out, state
        b = x.shape[0]
        assert b % self.num_splits == 0
        xs = x.reshape(self.num_splits, b // self.num_splits, *x.shape[1:])
        # per-split statistics: the split folds into the channel axis
        xs = torch.movedim(xs, 0, -2)  # (..., splits, C)
        xs = xs.reshape(*xs.shape[:-2], self.num_splits * self.dim)
        split_params = {"scale": params["scale"].repeat(self.num_splits),
                        "bias": params["bias"].repeat(self.num_splits)}
        out, new_split = batch_norm(split_params, state["split"], xs, training=True,
                                    momentum=momentum, eps=eps)
        out = out.reshape(*out.shape[:-1], self.num_splits, self.dim)
        out = torch.movedim(out, -2, 0).reshape(b, *x.shape[1:])
        return out, {**state, "split": new_split}

    def aggregate_stats(self, state: dict) -> dict:
        """The splits' running statistics folded into the global ones
        (batchnorm_helper.py:60-83: the mean of the means, the variance of
        the mixture)."""
        mean_s = state["split"]["mean"].reshape(self.num_splits, self.dim)
        var_s = state["split"]["var"].reshape(self.num_splits, self.dim)
        mean = mean_s.mean(dim=0)
        var = (var_s + mean_s.square()).mean(dim=0) - mean.square()
        return {**state, "global": {"mean": mean, "var": var}}


def _is_bn_stats(d) -> bool:
    return isinstance(d, dict) and set(d) == {"mean", "var"}


def _is_subbn_state(d) -> bool:
    return (isinstance(d, dict) and set(d) == {"split", "global"}
            and _is_bn_stats(d["split"]) and _is_bn_stats(d["global"]))


def sub_to_normal_bn_state(tree):
    """SubBN states in normal-BN layout for saving: only the aggregated
    global statistics (reference ``checkpoint.py:477-511`` ``sub_to_normal_bn``;
    call :meth:`SubBatchNorm.aggregate_stats` first, as the trainer does
    before a save)."""
    if _is_subbn_state(tree):
        return dict(tree["global"])
    if isinstance(tree, dict):
        return {k: sub_to_normal_bn_state(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [sub_to_normal_bn_state(v) for v in tree]
    return tree


def normal_to_sub_bn_state(ckpt_tree, model_tree):
    """Normal-BN statistics of a checkpoint expanded to SubBN layout where
    the model has one (reference ``checkpoint.py:538-577``
    ``normal_to_sub_bn``): the statistics become the global copy and,
    tiled ``num_splits`` times, the split copy. Subtrees the checkpoint
    lacks keep the model's values; SubBN states pass through."""
    if ckpt_tree is None:
        return model_tree
    if _is_subbn_state(model_tree):
        if _is_subbn_state(ckpt_tree):
            return ckpt_tree
        if _is_bn_stats(ckpt_tree):
            split_n = model_tree["split"]["mean"].shape[0]
            flat_n = ckpt_tree["mean"].shape[0]
            assert split_n % flat_n == 0, (split_n, flat_n)
            reps = split_n // flat_n
            return {"global": {k: torch.as_tensor(ckpt_tree[k]) for k in ("mean", "var")},
                    "split": {k: torch.as_tensor(ckpt_tree[k]).repeat(reps)
                              for k in ("mean", "var")}}
        return model_tree
    if isinstance(model_tree, dict):
        return {k: normal_to_sub_bn_state(ckpt_tree.get(k) if isinstance(ckpt_tree, dict)
                                          else None, v)
                for k, v in model_tree.items()}
    if isinstance(model_tree, list):
        return [normal_to_sub_bn_state(ckpt_tree[i] if isinstance(ckpt_tree, list)
                                       and i < len(ckpt_tree) else None, v)
                for i, v in enumerate(model_tree)]
    return ckpt_tree


def _tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def update_precise_stats(apply_fn: Callable, params, state, batches, num_iters: int):
    """Running statistics recomputed as the mean, over up to ``num_iters``
    batches, of the state ``apply_fn(params, state, batch)`` returns
    (precise BN, bn_helper.py:35-77)."""
    agg = _tree_map(torch.zeros_like, state)
    count = 0
    for i, batch in enumerate(batches):
        if i >= num_iters:
            break
        _, new_state = apply_fn(params, state, batch)
        agg = _tree_map(lambda a, s: a + s, agg, new_state)
        count += 1
    return _tree_map(lambda a: a / max(count, 1), agg)

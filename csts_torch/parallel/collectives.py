"""Collectives over the data axis (``csts_tpu/parallel/collectives.py``;
reference ``slowfast/utils/distributed.py``).

The data axis is the default process group, unless ``parallel/mesh.py``
has installed a mesh with model, seq or pipe axes: then it is the group of
the ranks that share this rank's place on those axes (:func:`set_data_group`),
and :func:`world_size`, :func:`rank`, the sums and the gathers run over it.
:func:`is_master_proc`, :func:`barrier` and :func:`any_rank` stay global.

Every helper is the identity on one process (no group started): the one-rank
path runs no collective. A group's tensors live on its backend's device:
the current CUDA device under NCCL, the CPU under gloo (which also takes
the CUDA tensors DDP hands it). ``local``, ``whole`` and ``shard_like``
move between FSDP2's DTensors and whole tensors. ``whole`` is
``DTensor.full_tensor``, a functional collective, which gloo cannot run on
CUDA tensors (it crashes, torch 2.11): on the card FSDP runs under NCCL.

``all_gather_with_grad`` replaces the reference's ``AllGather_multi``
(distributed.py:15-49), whose backward hands every rank rank 0's slice of the
gradient. Here each rank computes the same loss over the gathered rows, so
the backward sums the W ranks' gradients of the local rows (the
reduce-scatter of the sum, written as an all-reduce and a slice: the rows
are a few KB); DDP's mean then
divides by W, which gives the one-process gradient at the global batch.
"""

from __future__ import annotations

import pickle
from typing import Any, List

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


_DATA_GROUP = None  # the data axis's group under a mesh of several axes; None: the default


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def set_data_group(group) -> None:
    """The group the data axis's collectives run over (None: the default)."""
    global _DATA_GROUP
    _DATA_GROUP = group


def data_group():
    return _DATA_GROUP


def world_size() -> int:
    """The size of the data axis."""
    return dist.get_world_size(_DATA_GROUP) if initialized() else 1


def rank() -> int:
    """This rank's index on the data axis."""
    return dist.get_rank(_DATA_GROUP) if initialized() else 0


def is_master_proc() -> bool:
    """(distributed.py:160-173) Global rank 0."""
    return dist.get_rank() == 0 if initialized() else True


def barrier() -> None:
    """(distributed.py:176-185) Every rank of every axis."""
    if initialized() and dist.get_world_size() > 1:
        dist.barrier()


def comm_device() -> torch.device:
    """Where the group's own tensors (flags, sums, payloads) live."""
    if initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on ``x``'s device (a new tensor)."""
    if world_size() == 1:
        return x
    y = x.detach().to(comm_device(), copy=True)
    dist.all_reduce(y, group=_DATA_GROUP)
    return y.to(x.device)


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` holds on some rank (of every axis): one MAX
    all-reduce of an int."""
    if not initialized() or dist.get_world_size() == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def gather_objects(obj: Any) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order, on every rank: the
    pickles padded to the longest and all-gathered as bytes
    (all_gather_unaligned, distributed.py:266-302)."""
    w = world_size()
    if w == 1:
        return [obj]
    dev = comm_device()
    payload = torch.from_numpy(np.frombuffer(pickle.dumps(obj), dtype=np.uint8).copy()).to(dev)
    n = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(n) for _ in range(w)]
    dist.all_gather(sizes, n, group=_DATA_GROUP)
    sizes = [int(s.item()) for s in sizes]
    padded = torch.zeros(max(sizes), dtype=torch.uint8, device=dev)
    padded[:payload.numel()] = payload
    parts = [torch.empty_like(padded) for _ in range(w)]
    dist.all_gather(parts, padded, group=_DATA_GROUP)
    # the bytes are this program's own pickles, from the ranks of its group
    return [pickle.loads(p[:s].cpu().numpy().tobytes()) for p, s in zip(parts, sizes)]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        w = world_size()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(w)]
        dist.all_gather(parts, x, group=_DATA_GROUP)
        ctx.rows, ctx.rank = x.shape[0], rank()
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=_DATA_GROUP)
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
    order, differentiable: the backward sums the ranks' gradients of this
    rank's rows."""
    if world_size() == 1:
        return x
    return _AllGather.apply(x)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (a view of its storage), else ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


@torch.no_grad()
def whole(t: torch.Tensor, like: torch.Tensor = None) -> torch.Tensor:
    """A DTensor gathered whole on every rank (all ranks call it; no
    gradient flows), and then a part of the model axis's split (``t`` or
    the parameter ``like`` it is a state of, marked ``model_split``)
    gathered over that axis; else ``t``."""
    how = getattr(like if like is not None else t, "model_split", None)
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if how is not None:
        from csts_torch.parallel import mesh

        t = mesh.whole_split(t, how)
    return t


def shard_like(p: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` (a whole tensor of ``p``'s whole shape, in its own dtype)
    placed as ``p`` is: this rank's part of it when ``p`` is split on the
    model axis, this rank's shard of that when ``p`` is a DTensor (every
    rank holds ``value``, so no rank sends), else a copy on ``p``'s device."""
    how = getattr(p, "model_split", None)
    if how is not None:
        from csts_torch.parallel import mesh

        value = mesh.shard_split(value, how)
    if isinstance(p, DTensor):
        return distribute_tensor(value.to(p.device), p.device_mesh, p.placements,
                                 src_data_rank=None)
    return torch.empty_like(p, dtype=value.dtype).copy_(value)

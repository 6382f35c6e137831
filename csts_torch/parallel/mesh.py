"""The data axis of ``csts_tpu/parallel/mesh.py`` as a process group
(reference ``slowfast/utils/multiprocessing.py`` and ``launch_job``, SURVEY
§2 C20).

One process per device: ``NUM_SHARDS`` shards (hosts) of ``NUM_DEVICES``
processes each, rank ``SHARD_ID · NUM_DEVICES + local_rank``. The backend
follows the device: NCCL on CUDA (the process's own card, ``local_rank``),
gloo on the CPU. Each rank takes rows ``[r·lb, (r+1)·lb)`` of every global
batch (``local_rows``), so W ranks compute what one process computes at the
global batch. The model, seq and pipe axes of the JAX mesh are not ported.
"""

from __future__ import annotations

import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from csts_torch.config import Config
from csts_torch.parallel import collectives


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_axes(cfg: Config) -> None:
    """Only the data axis is ported."""
    p = cfg.PARALLEL
    if p.MODEL > 1 or p.SEQ > 1 or p.PIPE > 1:
        raise NotImplementedError(
            f"PARALLEL.MODEL/SEQ/PIPE {p.MODEL}/{p.SEQ}/{p.PIPE}: the model, seq and pipe axes "
            "are not ported yet (ROADMAP A.8); the port shards the data axis only")


def init_from_cfg(cfg: Config, device, local_rank: int = 0,
                  init_method: Optional[str] = None) -> torch.device:
    """Starts the default group of ``NUM_SHARDS × NUM_DEVICES`` processes as
    rank ``SHARD_ID · NUM_DEVICES + local_rank`` and returns this rank's
    device (on CUDA the card ``local_rank``, made current). ``init_method``
    is the rendezvous (``tcp://host:port``); a one-shard group without one
    meets on a free loopback port. Raises when the group does not start."""
    check_axes(cfg)
    world = cfg.NUM_SHARDS * cfg.NUM_DEVICES
    rank = cfg.SHARD_ID * cfg.NUM_DEVICES + local_rank
    device = torch.device(device)
    if device.type == "cuda":
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local_rank} has no card: "
                               f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    if init_method is None:
        if cfg.NUM_SHARDS > 1:
            raise ValueError("several shards need --init-method tcp://host:port")
        init_method = f"tcp://127.0.0.1:{free_port()}"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            device_id=device if backend == "nccl" else None)
    return device


def local_rows(global_batch_size: int) -> Tuple[int, int]:
    """(first row, rows) of this rank's stripe of a global batch."""
    w = collectives.world_size()
    if global_batch_size % w:
        raise ValueError(f"batch {global_batch_size} does not divide over {w} ranks")
    n = global_batch_size // w
    return collectives.rank() * n, n


def wrap_for_training(model: nn.Module, cfg: Config) -> nn.Module:
    """The module a training step calls. With a group started:
    ``DistributedDataParallel`` (its ``.module`` is ``model``), or under
    SOLVER.FSDP ``model`` itself with each transformer block and then the
    whole model sharded by FSDP2's ``fully_shard`` (in place: the parameters
    become DTensors, whole again inside each block's forward). Without a
    group, ``model``."""
    if not collectives.initialized():
        return model
    check_axes(cfg)
    if cfg.SOLVER.FSDP:
        from torch.distributed.fsdp import fully_shard

        from csts_torch.models.mvit import MultiScaleBlock

        for m in list(model.modules()):
            if isinstance(m, MultiScaleBlock):
                fully_shard(m)
        fully_shard(model)
        return model
    device = next(model.parameters()).device
    return nn.parallel.DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        # kldiv alone never reaches the NCE projections
        find_unused_parameters="nce" not in cfg.MODEL.LOSS_FUNC)

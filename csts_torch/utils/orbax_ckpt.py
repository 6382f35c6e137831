"""The ``TRAIN.CHECKPOINT_BACKEND "orbax"`` backend (``csts_tpu/utils/orbax_ckpt.py``):
async saves in which every rank writes its own shards, and restores straight
into the state's own layout, also from another layout, keyed by global
iteration. Storage goes through ``torch.distributed.checkpoint`` (DCP).

The npz backend (``utils/checkpoint.py``) keeps the reference's semantics:
every rank gathers the whole state and rank 0 writes one file. Here:

- **async save**: ``save`` stages this rank's part of the state to host
  memory (pinned on CUDA) and returns; ``dcp.async_save`` writes it on a
  thread of its own while training goes on. A second ``save`` first waits
  for the first.
- **each rank writes its own shards**: the state is described by
  ``checkpoint.local_state`` (no gather: FSDP2's shards, ZeRO-1's share of
  the moments, the model axis's parts, each at its place in the whole
  tensor), one file a rank; a tensor that several ranks hold alike (the
  copies the data, pipe and seq axes keep) is written once (DCP's
  de-duplication).
- **direct-to-shard restore**: ``restore`` loads each rank's pieces in
  place from whatever pieces the files hold, so a state saved on one
  layout restores on another (FSDP on 4 ranks into 2 or 1, dp2×tp2 into
  one process), and none is built whole on one rank.
- **a step counts once committed**: the files go to
  ``OUTPUT_DIR/checkpoints_orbax/<step>/`` (the JAX package's path), and a
  step is listed only once its DCP metadata is written and rank 0 has
  written :data:`COMMIT` beside it, so ``latest_step`` never names a
  half-written step. A failed write raises from ``wait``, ``close`` or the
  next ``save``.

The format is DCP's, not orbax's: the two packages do not read each
other's directories (the npz TrainState is their interchange).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.metadata import (ChunkStorageMetadata, MetadataIndex,
                                                   TensorProperties)
from torch.distributed.checkpoint.planner import TensorWriteData, WriteItem, WriteItemType

from csts_torch.parallel import collectives
from csts_torch.utils import checkpoint as cu
from csts_torch.utils.logging import get_logger

logger = get_logger(__name__)

CHECKPOINT_DIR = "checkpoints_orbax"
# written by rank 0 into a step's directory once every rank's files and
# DCP's metadata are there; a directory without it is not the port's
COMMIT = "csts_torch_commit.json"
_THREAD_PREFIX = "AsyncCheckpointExecutor"  # dcp.async_save's writer threads


def checkpoint_dir(output_dir: str) -> str:
    return os.path.abspath(os.path.join(output_dir, CHECKPOINT_DIR))


def committed_steps(output_dir: str) -> List[int]:
    """The committed steps under ``output_dir``, in order."""
    d = checkpoint_dir(output_dir)
    if not os.path.isdir(d):
        return []
    return sorted(int(n) for n in os.listdir(d)
                  if n.isdigit() and os.path.isfile(os.path.join(d, n, COMMIT)))


def has_checkpoint(output_dir: str) -> bool:
    return bool(committed_steps(output_dir))


class Pieces(torch.Tensor):
    """One tensor of the state as DCP sees it: the whole tensor's shape and
    dtype, holding only this rank's pieces (``checkpoint.Local``), each
    written and read as a chunk at its offsets. It carries no data of its
    own and takes no operation."""

    @staticmethod
    def __new__(cls, local: cu.Local):
        first = local.pieces[0][1]
        out = torch.Tensor._make_wrapper_subclass(cls, local.shape, dtype=first.dtype,
                                                  device=first.device)
        out._pieces = local.pieces
        return out

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise NotImplementedError(f"{func} on a checkpoint's pieces")

    def __create_write_items__(self, fqn: str, obj: Any) -> List[WriteItem]:
        return [WriteItem(index=MetadataIndex(fqn, torch.Size(at)), type=WriteItemType.SHARD,
                          tensor_data=TensorWriteData(
                              chunk=ChunkStorageMetadata(torch.Size(at), t.shape),
                              properties=TensorProperties(dtype=t.dtype),
                              size=self.shape))
                for at, t in self._pieces]

    def __create_chunk_list__(self) -> List[ChunkStorageMetadata]:
        return [ChunkStorageMetadata(torch.Size(at), t.shape) for at, t in self._pieces]

    def __get_tensor_shard__(self, index: MetadataIndex) -> torch.Tensor:
        for at, t in self._pieces:
            if torch.Size(at) == index.offset:
                return t
        raise ValueError(f"{index.fqn}: no piece at {index.offset}")


def _dcp_value(local: cu.Local):
    """A plain tensor where this rank holds the whole tensor (the ranks that
    hold it alike then write it once), else its :class:`Pieces`."""
    if len(local.pieces) == 1 and tuple(local.pieces[0][1].shape) == tuple(local.shape):
        return local.pieces[0][1]
    return Pieces(local)


class _Writer(dcp.FileSystemWriter):
    """DCP's file writer over a state dict that :meth:`OrbaxCheckpointer.save`
    has staged already (its own staging is the identity)."""

    def stage(self, state_dict):
        return state_dict


class OrbaxCheckpointer:
    """Saves and restores the port's TrainState keyed by GLOBAL ITERATION
    (the JAX package's ``OrbaxCheckpointer``): an epoch-e boundary save is
    step ``(e+1)·steps_per_epoch``, a mid-epoch preemption save at
    iteration i is ``e·steps_per_epoch + i``, so ``divmod(step,
    steps_per_epoch)`` is (start_epoch, start_iter) on resume.

    Every rank of the started group constructs it at the same point (it
    makes a gloo group of its own for DCP's coordination, which the writer
    thread uses while training runs its collectives on the others), and
    calls ``save``, ``restore``, ``wait`` and ``close`` in the same order.
    ``max_to_keep`` removes the oldest committed steps once a newer one has
    committed."""

    def __init__(self, output_dir: str, max_to_keep: Optional[int] = None):
        self.path = checkpoint_dir(output_dir)
        self.max_to_keep = max_to_keep
        self._pg = dist.new_group(backend="gloo") if collectives.initialized() else None
        self._coordinator = not collectives.initialized() or dist.get_rank() == 0
        self._pending: Optional[Tuple[int, Future]] = None
        self._lock = threading.Lock()
        self._done: Dict[int, Optional[BaseException]] = {}  # step -> its commit's error
        self._staging: Dict[Tuple[str, Tuple[int, ...]], torch.Tensor] = {}
        self.last_save: Dict[str, float] = {}  # the last save's staging: bytes, pieces

    def step_dir(self, step: int) -> str:
        return os.path.join(self.path, str(step))

    # -- saving ------------------------------------------------------------------------

    def _stage(self, local: Dict[str, cu.Local]) -> Dict[str, Any]:
        """Copies of this rank's pieces in host memory (pinned buffers kept
        from save to save for CUDA tensors), as DCP values."""
        staged, copies = {}, False
        n_bytes = 0
        for key, loc in local.items():
            pieces = []
            for at, t in loc.pieces:
                buf = self._staging.get((key, at))
                if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                    buf = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=t.device.type == "cuda")
                    self._staging[(key, at)] = buf
                buf.copy_(t.detach(), non_blocking=t.device.type == "cuda")
                copies |= t.device.type == "cuda"
                n_bytes += buf.numel() * buf.element_size()
                pieces.append((at, buf))
            staged[key] = _dcp_value(cu.Local(loc.shape, pieces))
        if copies:
            torch.cuda.synchronize()
        self.last_save = {"bytes": n_bytes, "pieces": sum(len(v.pieces) for v in local.values())}
        return staged

    def save(self, state, step: int) -> None:
        """Starts the async save of ``state`` (this rank's part of it) as
        ``step``: returns once the part is staged in host memory. Waits for
        the previous save first, and raises its error."""
        self.wait()
        if os.path.isfile(os.path.join(self.step_dir(step), COMMIT)):
            raise FileExistsError(f"step {step} is already committed in {self.path}")
        staged = self._stage(cu.local_state(state))
        future = dcp.async_save(staged, storage_writer=_Writer(self.step_dir(step)),
                                process_group=self._pg)
        future = getattr(future, "upload_completion", future)  # an AsyncSaveResponse
        self._pending = (step, future)
        future.add_done_callback(lambda f, s=step: self._commit(s, f))

    def _commit(self, step: int, future: Future) -> None:
        """Once ``step``'s write has completed (every rank's files and DCP's
        metadata): rank 0 writes the commit marker, then drops the oldest
        steps past ``max_to_keep``. Runs once, on the writer thread or in
        ``wait``; an error is kept for ``wait`` to raise."""
        with self._lock:
            if step in self._done:
                return
            err = future.exception()
            if err is None and self._coordinator:
                try:
                    d = self.step_dir(step)
                    tmp = os.path.join(d, COMMIT + ".tmp")
                    with open(tmp, "w") as f:
                        json.dump({"step": step, "format": "torch.distributed.checkpoint",
                                   "ranks": dist.get_world_size(self._pg) if self._pg else 1},
                                  f)
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, os.path.join(d, COMMIT))
                    if self.max_to_keep:
                        for old in committed_steps(os.path.dirname(self.path))[
                                :-self.max_to_keep]:
                            shutil.rmtree(self.step_dir(old))
                except OSError as e:
                    err = e
            self._done[step] = err

    def wait(self) -> None:
        """Blocks until the outstanding save has committed; raises if its
        write failed. Every rank calls it (a barrier follows the commit)."""
        if self._pending is None:
            return
        step, future = self._pending
        self._pending = None
        try:
            future.result()
        finally:
            self._commit(step, future)
        if self._pg is not None:
            dist.barrier(group=self._pg)
        if self._done[step] is not None:
            raise self._done[step]

    def close(self) -> None:
        """Waits for the outstanding save, then for the writer threads to
        end; releases the staging buffers and the group."""
        try:
            self.wait()
        finally:
            for t in threading.enumerate():
                if t.name.startswith(_THREAD_PREFIX) and t is not threading.current_thread():
                    t.join()
            self._staging.clear()
            if self._pg is not None:
                dist.destroy_process_group(self._pg)
                self._pg = None

    # -- restoring -----------------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = committed_steps(os.path.dirname(self.path))
        return steps[-1] if steps else None

    def restore(self, state, step: Optional[int] = None) -> Tuple[Any, int]:
        """Loads ``step`` (the latest committed if None) into ``state`` in
        place, each rank straight into its own pieces of the state's layout;
        returns (state, step), or (state, -1) when there is none."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return state, -1
        if not os.path.isfile(os.path.join(self.step_dir(step), COMMIT)):
            raise FileNotFoundError(f"step {step} is not committed in {self.path}")
        local = cu.local_state(state, create=True)
        dcp.load({k: _dcp_value(v) for k, v in local.items()},
                 storage_reader=dcp.FileSystemReader(self.step_dir(step)),
                 process_group=self._pg)
        cu.load_local_state(state, local)
        logger.info("Restored checkpoint step %d from %s.", step, self.path)
        return state, step

    def restore_params(self, model: torch.nn.Module, use_ema: bool = False,
                       step: Optional[int] = None) -> Tuple[int, bool]:
        """The weights of ``step`` (the latest committed if None) into the
        whole parameters of ``model`` (the tester's load: no TrainState),
        the EMA's with ``use_ema`` where the step has them; returns (step,
        whether the EMA's were loaded)."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no committed step in {self.path}")
        keys = dcp.FileSystemReader(self.step_dir(step)).read_metadata().state_dict_metadata
        ema = use_ema and any(k.startswith("ema.") for k in keys)
        prefix = "ema." if ema else "model."
        dcp.load({prefix + n: p.detach() for n, p in model.named_parameters()},
                 storage_reader=dcp.FileSystemReader(self.step_dir(step)),
                 process_group=self._pg)
        return step, ema

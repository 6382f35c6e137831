"""Input pipeline: a torch ``DataLoader`` over the clip dataset, and a
device prefetcher (``csts_tpu/data/loader.py``; reference
``slowfast/datasets/loader.py:44-130``).

* Per-epoch order seeded by (seed, epoch), as the JAX loader's
  ``_epoch_order`` (train shuffles, val/test keep the file order).
* Per-sample RNG seeded by (seed, epoch, position in the epoch order): the
  augmentations do not depend on the worker count or on which worker loads
  a sample, and a sample draws the same numbers as in the JAX loader.
* Worker processes are forked from a fork server (``forkserver``:
  DATA_LOADER.NUM_WORKERS of them; 0 loads in the calling process), never
  from the calling process, whose CUDA context and threads a fork would
  copy. The server imports torch and this module once, when it starts
  (``set_forkserver_preload``), so a worker it forks starts with them, where
  ``spawn`` imports them in every worker. (Python 3.12's server never
  imports ``__main__``, its default preload: it is not handed the main
  module's path. Each worker then imported torch itself: a loader's first
  batch waited ~3 s on a CPU-only host, ~20 s on an H100's host.) Each
  worker receives the dataset's arguments and builds its index itself
  (``AVGazeDataset.__getstate__``). Batches come back as
  tensors, pinned when DATA_LOADER.PIN_MEMORY holds and the device is CUDA.
  The workers outlive an epoch (``persistent_workers``), so a trainer's
  epochs and validations start none, and they ignore SIGTERM: a
  preemption signal sent to the whole process group leaves them serving
  the main process until it has saved its checkpoint.
* So the workers end only when their loader is closed: ``GazeLoader.close()``
  (or the end of its ``with`` block) shuts them down, joins them and
  SIGKILLs any still alive (``terminate()`` sends the SIGTERM they
  ignore). Every caller closes its loaders in a ``finally``. An ``atexit``
  hook closes those still open at interpreter exit, before
  ``multiprocessing``'s own exit handler, which would otherwise SIGTERM
  the workers and wait for them forever.
* The final batch of val/test stays short (the JAX loader wrap-pads it to
  keep jit shapes static); the meters drop repeated dataset indices either
  way. Train drops the incomplete final batch.
* With several processes rank r of W reads rows ``[r·lb, (r+1)·lb)`` of each
  global batch, ``lb = BATCH_SIZE / W``: the JAX loader's host stripes
  (``csts_tpu/data/loader.py:95-107``), not ``DistributedSampler``'s
  strides, so W ranks see what one process sees at the global batch. The
  sample seeds stay keyed by global position, whatever the rank. A stripe
  of the short final batch may be empty: that rank's epoch has one batch
  fewer (``EpochBatches.num_batches`` counts the global batches).
"""

from __future__ import annotations

import atexit
import multiprocessing
import multiprocessing.util  # noqa: F401 — its exit handler registers first, runs last
import queue
import signal
import threading
import weakref
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler

from csts_torch.config import Config
from csts_torch.data.datasets import AVGazeDataset, build_dataset
from csts_torch.parallel import collectives

BATCH_KEYS = ("video", "audio", "labels", "labels_hm")
FORKSERVER_PRELOAD = ["torch", __name__]  # what the workers' fork server imports once
HOST_KEYS = ("index",)  # what the prefetcher leaves on the host


def collate(samples) -> Dict[str, torch.Tensor]:
    """Dataset items -> one batch: video (B,T,H,W,3) uint8 (or float32), audio
    (B,T,F,S,1) float16 (or float32), labels (B,T,3), labels_hm (B,T,h,w),
    index (B,) int64."""
    batch = {key: torch.from_numpy(np.stack([s[key] for s in samples])) for key in BATCH_KEYS}
    batch["index"] = torch.as_tensor([int(s["index"]) for s in samples], dtype=torch.int64)
    return batch


def _ignore_sigterm(worker_id: int) -> None:
    signal.signal(signal.SIGTERM, signal.SIG_IGN)


class SeededItems(Dataset):
    """The clip dataset read by (index, epoch, position) keys: each item draws
    from ``np.random.default_rng((seed, epoch, position))``."""

    def __init__(self, dataset: AVGazeDataset, seed: int):
        self.dataset = dataset
        self.seed = seed

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, key: Tuple[int, int, int]):
        index, epoch, position = key
        rng = np.random.default_rng((self.seed, epoch, position))
        return self.dataset.__getitem__(index, rng=rng)


class EpochBatches(Sampler):
    """Rank ``rank``'s stripes of the global batches (``batch_size`` rows
    each) as (index, epoch, position) keys, in the (seed, epoch) order."""

    def __init__(self, n: int, batch_size: int, shuffle: bool, seed: int, drop_last: bool,
                 rank: int = 0, world: int = 1):
        if batch_size % world:
            raise ValueError(f"batch {batch_size} does not divide over {world} ranks")
        self.n = n
        self.batch_size = batch_size
        self.local_batch_size = batch_size // world
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.start_iter = 0

    def num_batches(self) -> int:
        """The global batches of an epoch."""
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def __len__(self) -> int:
        """This rank's batches: the global ones, less the last where this
        rank's stripe of it is empty."""
        total = self.num_batches()
        if total and (total - 1) * self.batch_size + self.rank * self.local_batch_size >= self.n:
            return total - 1
        return total

    def order(self) -> np.ndarray:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        return order

    def __iter__(self) -> Iterator[List[Tuple[int, int, int]]]:
        order = self.order()
        for b in range(self.start_iter, len(self)):
            lo = b * self.batch_size + self.rank * self.local_batch_size
            hi = min(lo + self.local_batch_size, self.n)
            yield [(int(order[p]), self.epoch, p) for p in range(lo, hi)]


JOIN_TIMEOUT_S = 10.0  # a closing loader's wait for each worker before SIGKILL
_LIVE: "weakref.WeakSet[GazeLoader]" = weakref.WeakSet()  # loaders not yet closed


class GazeLoader(DataLoader):
    """A ``DataLoader`` over :class:`SeededItems` batched by :class:`EpochBatches`.

    A context manager: leaving the block closes it. A closed loader
    raises on ``iter``; a new epoch after ``close()`` needs a loader built
    anew (``construct_loader``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._closed = False
        _LIVE.add(self)

    def __iter__(self):
        if self._closed:
            raise RuntimeError("the loader is closed; construct_loader builds a new one")
        return super().__iter__()

    def close(self, timeout: float = JOIN_TIMEOUT_S) -> None:
        """Shuts down the workers of the live iterator and joins each for up
        to ``timeout`` seconds; SIGKILLs any still alive. Idempotent."""
        self._closed = True
        _LIVE.discard(self)
        it, self._iterator = self._iterator, None
        workers = list(getattr(it, "_workers", ()))
        if not workers:
            return
        it._shutdown_workers()  # the workers' stop message, a bounded join
        for w in workers:
            w.join(timeout)
            if w.is_alive():
                w.kill()
                w.join(timeout)

    def __enter__(self) -> "GazeLoader":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def set_epoch(self, epoch: int, start_iter: int = 0) -> None:
        """Seeded epoch order (shuffle_dataset, loader.py:112-130); ``start_iter``
        resumes the epoch at that batch, with the same samples and draws as
        the uninterrupted epoch."""
        self.batch_sampler.epoch = epoch
        self.batch_sampler.start_iter = start_iter


def construct_loader(cfg: Config, split: str, device: Optional[torch.device] = None,
                     seed_offset: int = 0) -> GazeLoader:
    """(reference construct_loader, loader.py:44-109): this rank's stripes.
    ``device`` is where the batches go: CUDA pins them when
    DATA_LOADER.PIN_MEMORY holds."""
    if split not in ("train", "val", "test"):
        raise ValueError(f"unknown split {split!r}")
    if split == "test":
        dataset_name, batch_size = cfg.TEST.DATASET, cfg.TEST.BATCH_SIZE
    else:
        dataset_name, batch_size = cfg.TRAIN.DATASET, cfg.TRAIN.BATCH_SIZE
    train = split == "train"
    dataset = build_dataset(dataset_name, cfg, split)
    seed = cfg.RNG_SEED + seed_offset
    workers = cfg.DATA_LOADER.NUM_WORKERS
    if workers > 0:  # read when the fork server starts (the first loader's)
        multiprocessing.get_context("forkserver").set_forkserver_preload(FORKSERVER_PRELOAD)
    return GazeLoader(
        SeededItems(dataset, seed),
        batch_sampler=EpochBatches(len(dataset), batch_size, train, seed, drop_last=train,
                                   rank=collectives.rank(), world=collectives.world_size()),
        collate_fn=collate,
        num_workers=workers,
        multiprocessing_context="forkserver" if workers > 0 else None,
        persistent_workers=workers > 0,
        worker_init_fn=_ignore_sigterm if workers > 0 else None,
        pin_memory=bool(cfg.DATA_LOADER.PIN_MEMORY and device is not None
                        and device.type == "cuda"),
    )


@atexit.register
def close_all() -> int:
    """Closes every loader still open; returns how many there were."""
    loaders = list(_LIVE)
    for loader in loaders:
        loader.close()
    return len(loaders)


class DevicePrefetcher:
    """Moves the loader's batches to ``device`` up to ``depth`` ahead, from a
    thread.

    On CUDA the copies are non-blocking on a side stream; the consumer's
    stream waits on each batch's event, and the batch's tensors are marked
    as used on the consumer's stream. The dataset indices stay on the host,
    where the meters read them. A failure in the loader or
    in a copy is raised by the consumer's ``next``, and by every ``next``
    after it: the epoch never ends early without it
    (``csts_tpu/data/loader.py:197-212``).
    """

    def __init__(self, iterator, device: torch.device, depth: int = 2):
        self._it = iterator
        self._device = device
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._done = object()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _place(self, batch: Dict[str, torch.Tensor]):
        if self._stream is None:
            return {k: v if k in HOST_KEYS else v.to(self._device)
                    for k, v in batch.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: v if k in HOST_KEYS else v.to(self._device, non_blocking=True)
                   for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _run(self):
        try:
            for batch in self._it:
                if self._stop.is_set():
                    break
                self._q.put(self._place(batch))
        except BaseException as exc:  # noqa: BLE001 — raised again in __next__
            self._error = exc
        finally:
            self._q.put(self._done)

    def close(self):
        """Stop early: unblock the producer and join it."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if item is self._done:
            self._q.put(self._done)  # a later next() ends too
            if self._error is not None and not self._stop.is_set():
                raise self._error
            raise StopIteration
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for k, v in batch.items():
                if k not in HOST_KEYS:
                    v.record_stream(stream)
        return batch

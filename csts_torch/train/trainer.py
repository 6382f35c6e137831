"""The training entry point: ``train(cfg)`` (``csts_tpu/train/trainer.py``;
reference ``tools/train_avgaze_net.py:25-361``).

The state (``create_train_state``), then the load chain
(``utils/checkpoint.load_train_checkpoint``: auto-resume, an npz TrainState,
or a ``.pyth`` fine-tune init with its audio branch); per epoch the train
loader in its (seed, epoch) order behind the device prefetcher, one
``train_step`` a batch with the per-iteration metrics and the NaN check,
the checkpoint and validation periods (the EMA weights are validated when
SOLVER.EMA_DECAY > 0). It runs on CUDA unless ``device`` names another
device, and raises with no CUDA and no device given.

Preemption: SIGTERM sets a flag; the iteration loop saves an iter-tagged npz
within one step and returns, and auto-resume continues that epoch at that
iteration. The stochastic-depth masks of iteration i of epoch e come from a
``torch.Generator`` seeded from (RNG_SEED, e, i), and the loader's order and
draws are keyed the same way, so a resumed run replays the uninterrupted
one. ``_PREEMPT_AFTER_ITERS`` injects the signal after that many iterations
of the first trained epoch (drills and tests).
"""

from __future__ import annotations

import contextlib
import os
import pprint
import signal
import threading
from typing import Dict, Optional

import numpy as np
import torch

from csts_torch import resolve_device
from csts_torch.config import Config
from csts_torch.data import loader as loader_lib
from csts_torch.eval import metrics
from csts_torch.models.csts import build_spec
from csts_torch.train import step as step_lib
from csts_torch.train.meters import EpochTimer, TrainGazeMeter, ValGazeMeter
from csts_torch.utils import checkpoint as cu
from csts_torch.utils.logging import get_logger, setup_logging

logger = get_logger(__name__)

_PREEMPTED = threading.Event()
# fault injection: behave as if SIGTERM arrived after this many iterations of
# the first trained epoch; None = off
_PREEMPT_AFTER_ITERS: Optional[int] = None


def _install_preemption_handler():
    """Sets the SIGTERM handler; returns the one it replaced (None off the
    main thread, where no handler can be set)."""
    def handler(signum, frame):
        logger.info("Received signal %s — will checkpoint and exit.", signum)
        _PREEMPTED.set()

    try:
        return signal.signal(signal.SIGTERM, handler)
    except ValueError:  # not the main thread
        return None


def drop_generator(seed: int, epoch: int, iteration: int) -> torch.Generator:
    """The generator of one iteration's stochastic-depth masks: a pure
    function of (seed, epoch, iteration)."""
    state = np.random.SeedSequence([seed, epoch, iteration]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _check_options(cfg: Config) -> None:
    if cfg.TRAIN.CHECKPOINT_BACKEND != "npz":
        raise NotImplementedError(
            f"TRAIN.CHECKPOINT_BACKEND {cfg.TRAIN.CHECKPOINT_BACKEND!r}: only npz is ported "
            "(orbax goes with several processes, ROADMAP A.8)")
    if cfg.TENSORBOARD.ENABLE:
        raise NotImplementedError("TENSORBOARD.ENABLE is not ported yet (ROADMAP A.9)")


@contextlib.contextmanager
def _weights(model: torch.nn.Module, named: Optional[Dict[str, torch.Tensor]]):
    """``model`` with ``named`` weights in place of its own for the block
    (the EMA's, for validation); its own come back bit for bit after."""
    if named is None:
        yield
        return
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    try:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(named[n])
        yield
    finally:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(saved[n])


def train(cfg: Config, device=None) -> step_lib.TrainState:
    """Trains for SOLVER.MAX_EPOCH epochs from the load chain's start (or
    until preempted); returns the state."""
    device = resolve_device(device)
    _check_options(cfg)
    setup_logging(cfg.OUTPUT_DIR)
    logger.info("Train with config:")
    logger.info(pprint.pformat(cfg.dump()))
    if cfg.DEBUG_NANS:
        torch.autograd.set_detect_anomaly(True)

    spec = build_spec(cfg)
    # the loaders' workers start first, while the model is built and loaded
    train_loader = loader_lib.construct_loader(cfg, "train", device)
    val_loader = loader_lib.construct_loader(cfg, "val", device)
    steps_per_epoch = max(len(train_loader), 1)
    state = step_lib.create_train_state(
        cfg, spec, torch.Generator().manual_seed(cfg.RNG_SEED), device=device)
    start_epoch, start_iter = cu.load_train_checkpoint(cfg, state)
    train_step = step_lib.make_train_step(cfg, spec, steps_per_epoch,
                                          accum_steps=cfg.TRAIN.GRAD_ACCUM_STEPS)
    eval_step = step_lib.make_eval_step(cfg, spec)
    train_meter = TrainGazeMeter(len(train_loader), cfg, device)
    val_meter = ValGazeMeter(len(val_loader), cfg, device)
    epoch_timer = EpochTimer()
    profile = {"done": False}  # the TRAIN.PROFILE_* trace is taken once a call

    _PREEMPTED.clear()
    previous = _install_preemption_handler()
    try:
        logger.info("Start epoch: %d (iter %d)", start_epoch + 1, start_iter)
        for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
            epoch_start_iter = start_iter if cur_epoch == start_epoch else 0
            train_loader.set_epoch(cur_epoch, start_iter=epoch_start_iter)
            epoch_timer.epoch_tic()
            stopped_at = _train_epoch(train_loader, state, train_step, train_meter, cur_epoch,
                                      cfg, device, profile, start_iter=epoch_start_iter)
            epoch_timer.epoch_toc()
            if stopped_at is not None:
                cu.save_checkpoint(cfg.OUTPUT_DIR, state, cur_epoch - 1, cfg,
                                   iter_idx=stopped_at)
                logger.info("Preemption checkpoint saved (epoch %d, iter %d); exiting.",
                            cur_epoch + 1, stopped_at)
                break
            logger.info("Epoch %d takes %.2fs (avg %.2fs/iter).", cur_epoch + 1,
                        epoch_timer.last_epoch_time(),
                        epoch_timer.last_epoch_time() / max(len(train_loader), 1))
            saved = (cur_epoch + 1) % cfg.TRAIN.CHECKPOINT_PERIOD == 0
            if saved:
                cu.save_checkpoint(cfg.OUTPUT_DIR, state, cur_epoch, cfg)
            if (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0:
                _eval_epoch(val_loader, state, eval_step, val_meter, cur_epoch, cfg, device)
            if _PREEMPTED.is_set():
                # preempted on the epoch's last iteration: exit at the boundary
                if not saved:
                    cu.save_checkpoint(cfg.OUTPUT_DIR, state, cur_epoch, cfg)
                logger.info("Preemption checkpoint saved (epoch %d); exiting.", cur_epoch + 1)
                break
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    logger.info("Training finished!")
    return state


def _train_epoch(train_loader, state, train_step, meter, cur_epoch: int, cfg, device,
                 profile: dict, start_iter: int = 0) -> Optional[int]:
    """One epoch from iteration ``start_iter``. Returns the next iteration to
    run when the epoch was preempted, else None. ``profile["done"]`` marks
    the TRAIN.PROFILE_* window as taken."""
    meter.iter_tic()
    data_size = len(train_loader)
    dataset_name = cfg.TRAIN.DATASET
    stopped_at = None
    prof = None
    prof_end = cfg.TRAIN.PROFILE_START_ITER + cfg.TRAIN.PROFILE_NUM_ITERS
    with loader_lib.DevicePrefetcher(iter(train_loader), device,
                                     depth=cfg.DATA_LOADER.PREFETCH_DEPTH) as prefetch:
        for offset, batch in enumerate(prefetch):
            cur_iter = start_iter + offset
            if (cfg.TRAIN.PROFILE_NUM_ITERS and not profile["done"]
                    and cur_iter == cfg.TRAIN.PROFILE_START_ITER):
                prof = _start_profile(device)
            meter.data_toc()
            stats, preds = train_step(state, batch,
                                      drop_generator(cfg.RNG_SEED, cur_epoch, cur_iter))
            loss = float(stats["loss"])  # waits for the step
            if prof is not None and cur_iter + 1 >= prof_end:
                _stop_profile(prof, cfg, cur_epoch)
                prof, profile["done"] = None, True
            lr = float(stats["lr"])
            step_lib.check_nan_loss(loss, cur_iter)
            f1, recall, precision, threshold = metrics.adaptive_f1(
                metrics.minmax_rescale(preds), batch["labels_hm"], batch["labels"], dataset_name)
            meter.update_stats(f1, recall, precision, threshold, loss, lr,
                               mb_size=batch["labels"].shape[0])
            if "egonce_loss" in stats and (cur_iter + 1) % cfg.LOG_PERIOD == 0:
                logger.info("Iter %d: kld_loss %.4f, egonce_loss %.4f, loss %.4f", cur_iter + 1,
                            float(stats["kldiv_loss"]), float(stats["egonce_loss"]), loss)
            meter.iter_toc()
            meter.log_iter_stats(cur_epoch, cur_iter)
            meter.iter_tic()
            if _PREEMPT_AFTER_ITERS is not None and offset + 1 >= _PREEMPT_AFTER_ITERS:
                _PREEMPTED.set()
            # on the epoch's last iteration a preemption is an epoch-boundary
            # exit (the caller's), not a save pointing past the end
            if _PREEMPTED.is_set() and cur_iter + 1 < data_size:
                stopped_at = cur_iter + 1
                break
    if prof is not None:  # the epoch ended inside the trace window
        _stop_profile(prof, cfg, cur_epoch)
        profile["done"] = True
    if stopped_at is None:
        meter.log_epoch_stats(cur_epoch)
    meter.reset()
    return stopped_at


def _start_profile(device) -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof: torch.profiler.profile, cfg, cur_epoch: int) -> None:
    """Ends the TRAIN.PROFILE_* window and writes its trace (Chrome format)
    to OUTPUT_DIR/profile."""
    prof.stop()
    out = os.path.join(cfg.OUTPUT_DIR, "profile")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"trace_epoch{cur_epoch + 1:05d}.json")
    prof.export_chrome_trace(path)
    logger.info("Profiled iterations [%d, %d) to %s", cfg.TRAIN.PROFILE_START_ITER,
                cfg.TRAIN.PROFILE_START_ITER + cfg.TRAIN.PROFILE_NUM_ITERS, path)


def _eval_epoch(val_loader, state, eval_step, meter, cur_epoch: int, cfg, device) -> None:
    """Validation: the eval forward (``make_eval_step``: the eval dispatch
    in the compute dtype) of the EMA weights when there are any, else the
    weights; per batch the adaptive F1, weighted by its fixation frames. The
    val split's final batch stays short (the JAX loader repeats leading rows
    to fill it)."""
    meter.iter_tic()
    dataset_name = cfg.TRAIN.DATASET
    fix_idx = metrics.fixation_index(dataset_name)
    with _weights(state.model, state.ema), loader_lib.DevicePrefetcher(
            iter(val_loader), device, depth=cfg.DATA_LOADER.PREFETCH_DEPTH) as prefetch:
        for cur_iter, batch in enumerate(prefetch):
            meter.data_toc()
            preds = eval_step(state.model, batch)
            f1, recall, precision, threshold = metrics.adaptive_f1(
                metrics.minmax_rescale(preds), batch["labels_hm"], batch["labels"], dataset_name)
            meter.iter_toc()
            weight = int((batch["labels"][:, :, 2] == fix_idx).sum())
            meter.update_stats(f1, recall, precision, None, threshold, fix_idx, weight=weight)
            meter.log_iter_stats(cur_epoch, cur_iter)
            meter.iter_tic()
    meter.log_epoch_stats(cur_epoch)
    meter.reset()

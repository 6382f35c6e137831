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

Checkpoints (TRAIN.CHECKPOINT_BACKEND): "npz" writes the JAX package's
npz TrainState (``utils/checkpoint.py``: rank 0, every rank gathering the
whole state); "orbax" saves through ``utils/orbax_ckpt.py`` asynchronously,
each rank its own pieces, keyed by global iteration (an epoch boundary
``(epoch + 1) · steps_per_epoch``, a preemption ``epoch · steps_per_epoch +
iteration``), and with TRAIN.AUTO_RESUME its latest committed step wins
over the npz chain, restored into the state after ``mesh.wrap_for_training``
(each rank straight into its own layout). ``train`` returns, on success,
error or preemption, only once the last save has committed.

Preemption: SIGTERM sets a flag; the iteration loop saves an iter-tagged
checkpoint within one step and returns, and auto-resume continues that
epoch at that iteration. The stochastic-depth masks of iteration i of epoch
e come from a ``torch.Generator`` seeded from (RNG_SEED, e, i), and the
loader's order and draws are keyed the same way, so a resumed run replays
the uninterrupted one. ``_PREEMPT_AFTER_ITERS`` injects the signal after that many iterations
of the first trained epoch (drills and tests).

Several processes: when the caller has started a process group
(``parallel/mesh.py`` ``init_from_cfg``, as ``run_net`` does), each rank
loads its stripe of every global batch, steps through DDP (or ZeRO-1 /
FSDP under SOLVER.ZERO1 / SOLVER.FSDP), and the train and val records are
the global batch's (the metrics' sums added over the ranks before the
division), logged by rank 0. Rank 0 writes each npz. SIGTERM may
reach one rank first: every iteration the ranks agree on the stop flag
(one MAX all-reduce), so all save and stop at the same iteration and none
waits in a collective the others left.
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
from csts_torch.parallel import collectives
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
    if cfg.TRAIN.CHECKPOINT_BACKEND not in ("npz", "orbax"):
        raise ValueError(f"TRAIN.CHECKPOINT_BACKEND {cfg.TRAIN.CHECKPOINT_BACKEND!r}: "
                         "npz or orbax")


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
    until preempted); returns the state. With a process group started, this
    rank's part of a data-parallel run (``device`` its own card)."""
    device = resolve_device(device)
    _check_options(cfg)
    setup_logging(cfg.OUTPUT_DIR)
    logger.info("Train with config:")
    logger.info(pprint.pformat(cfg.dump()))
    if cfg.DEBUG_NANS:
        torch.autograd.set_detect_anomaly(True)

    # the loaders' workers start first, while the model is built and loaded;
    # they stop when training ends, on success, error or preemption
    with loader_lib.construct_loader(cfg, "train", device) as train_loader, \
            loader_lib.construct_loader(cfg, "val", device) as val_loader:
        return _fit(cfg, device, train_loader, val_loader)


def _fit(cfg: Config, device, train_loader, val_loader) -> step_lib.TrainState:
    """``train``'s body over its two loaders."""
    spec = build_spec(cfg)
    steps_per_epoch = max(len(train_loader), 1)
    # the state comes wrapped for the process group (mesh.wrap_for_training),
    # so the orbax backend restores each rank's pieces straight into its
    # own layout; the npz chain (and .pyth fine-tune init) loads whole files
    state = step_lib.create_train_state(
        cfg, spec, torch.Generator().manual_seed(cfg.RNG_SEED), device=device)
    ckpt = None
    if cfg.TRAIN.CHECKPOINT_BACKEND == "orbax":
        from csts_torch.utils import orbax_ckpt

        ckpt = orbax_ckpt.OrbaxCheckpointer(cfg.OUTPUT_DIR)
    try:
        return _fit_state(cfg, device, train_loader, val_loader, spec, steps_per_epoch, state,
                          ckpt)
    finally:
        if ckpt is not None:
            ckpt.close()  # waits: no write outlives train(), and a failed one raises


def _save(cfg, ckpt, state, epoch: int, steps_per_epoch: int,
          iter_idx: Optional[int] = None) -> None:
    """Checkpoints ``state`` after ``epoch`` (the last completed one) and
    ``iter_idx`` iterations of the next: an npz, or through the orbax
    backend an async save keyed by global iteration."""
    if ckpt is None:
        cu.save_checkpoint(cfg.OUTPUT_DIR, state, epoch, cfg, iter_idx=iter_idx)
    else:
        ckpt.save(state, (epoch + 1) * steps_per_epoch + (iter_idx or 0))


def _fit_state(cfg: Config, device, train_loader, val_loader, spec, steps_per_epoch: int,
               state: step_lib.TrainState, ckpt) -> step_lib.TrainState:
    """``_fit`` from the made state, with the orbax checkpointer ``ckpt``
    (None: npz)."""
    resume_step = ckpt.latest_step() if ckpt is not None and cfg.TRAIN.AUTO_RESUME else None
    if resume_step is None:
        start_epoch, start_iter = cu.load_train_checkpoint(cfg, state)
    else:
        # boundary saves land on epoch multiples (start_iter 0), preemption
        # saves mid-epoch
        ckpt.restore(state, resume_step)
        start_epoch, start_iter = divmod(resume_step, steps_per_epoch)
    train_step = step_lib.make_train_step(cfg, spec, steps_per_epoch,
                                          accum_steps=cfg.TRAIN.GRAD_ACCUM_STEPS)
    eval_step = step_lib.make_eval_step(cfg, spec)
    train_meter = TrainGazeMeter(len(train_loader), cfg, device)
    val_meter = ValGazeMeter(len(val_loader), cfg, device)
    epoch_timer = EpochTimer()
    profile = {"done": False}  # the TRAIN.PROFILE_* trace is taken once a call
    writer = None
    if cfg.TENSORBOARD.ENABLE and collectives.is_master_proc():
        from csts_torch.utils.tensorboard import TensorboardWriter

        writer = TensorboardWriter(cfg)

    _PREEMPTED.clear()
    previous = _install_preemption_handler()
    try:
        logger.info("Start epoch: %d (iter %d)", start_epoch + 1, start_iter)
        for cur_epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCH):
            epoch_start_iter = start_iter if cur_epoch == start_epoch else 0
            train_loader.set_epoch(cur_epoch, start_iter=epoch_start_iter)
            epoch_timer.epoch_tic()
            stopped_at = _train_epoch(train_loader, state, train_step, train_meter, cur_epoch,
                                      cfg, device, profile, writer, start_iter=epoch_start_iter)
            epoch_timer.epoch_toc()
            if stopped_at is not None:
                _save(cfg, ckpt, state, cur_epoch - 1, steps_per_epoch, iter_idx=stopped_at)
                logger.info("Preemption checkpoint saved (epoch %d, iter %d); exiting.",
                            cur_epoch + 1, stopped_at)
                break
            logger.info("Epoch %d takes %.2fs (avg %.2fs/iter).", cur_epoch + 1,
                        epoch_timer.last_epoch_time(),
                        epoch_timer.last_epoch_time() / max(len(train_loader), 1))
            saved = (cur_epoch + 1) % cfg.TRAIN.CHECKPOINT_PERIOD == 0
            if saved:
                _save(cfg, ckpt, state, cur_epoch, steps_per_epoch)
            if (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0:
                _eval_epoch(val_loader, state, eval_step, val_meter, cur_epoch, cfg, device)
            if collectives.any_rank(_PREEMPTED.is_set()):
                # preempted on the epoch's last iteration: exit at the boundary
                if not saved:
                    _save(cfg, ckpt, state, cur_epoch, steps_per_epoch)
                logger.info("Preemption checkpoint saved (epoch %d); exiting.", cur_epoch + 1)
                break
        if ckpt is not None:
            ckpt.wait()
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
        if writer is not None:
            writer.close()
    logger.info("Training finished!")
    return state


def _train_epoch(train_loader, state, train_step, meter, cur_epoch: int, cfg, device,
                 profile: dict, writer=None, start_iter: int = 0) -> Optional[int]:
    """One epoch from iteration ``start_iter``. Returns the next iteration to
    run when the epoch was preempted, else None. ``profile["done"]`` marks
    the TRAIN.PROFILE_* window as taken; ``writer`` (rank 0's
    TENSORBOARD.ENABLE) takes each iteration's scalars."""
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
                    and cur_iter == cfg.TRAIN.PROFILE_START_ITER and collectives.is_master_proc()):
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
            sums = collectives.all_reduce_sum(metrics.f1_sums(
                metrics.minmax_rescale(preds), batch["labels_hm"], batch["labels"], dataset_name))
            f1, recall, precision, threshold = metrics.best_f1(sums, dataset_name)
            meter.update_stats(f1, recall, precision, threshold, loss, lr,
                               mb_size=batch["labels"].shape[0] * collectives.world_size())
            if writer is not None:
                scalars = {"Train/loss": loss, "Train/lr": lr, "Train/F1": f1,
                           "Train/Recall": recall, "Train/Precision": precision}
                if "egonce_loss" in stats:
                    scalars["Train/kldiv_loss"] = float(stats["kldiv_loss"])
                    scalars["Train/nce_loss"] = float(stats["egonce_loss"])
                writer.add_scalars(scalars, global_step=data_size * cur_epoch + cur_iter)
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
            if collectives.any_rank(_PREEMPTED.is_set()) and cur_iter + 1 < data_size:
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


def _first_row(loader, epoch: int, device) -> Dict[str, torch.Tensor]:
    """The loader's first clip as a batch of one on ``device``."""
    batch = loader.collate_fn([loader.dataset[(0, epoch, 0)]])
    return {k: v.to(device) for k, v in batch.items() if k not in loader_lib.HOST_KEYS}


def _eval_epoch(val_loader, state, eval_step, meter, cur_epoch: int, cfg, device) -> None:
    """Validation: the eval forward (``make_eval_step``: the eval dispatch
    in the compute dtype) of the EMA weights when there are any, else the
    weights; per global batch the adaptive F1, weighted by its fixation
    frames. The val split's final batch stays short (the JAX loader repeats
    leading rows to fill it); a rank whose stripe of it is empty adds zero
    sums to that batch's. Under FSDP, where each forward gathers the
    parameters on every rank, that rank also runs the forward on one
    placeholder row (the split's first), scored nowhere; else it runs none."""
    meter.iter_tic()
    dataset_name = cfg.TRAIN.DATASET
    k = len(metrics.thresholds_for(dataset_name))

    def record(cur_iter: int, sums: torch.Tensor) -> None:
        sums = collectives.all_reduce_sum(sums)
        f1, recall, precision, threshold = metrics.best_f1(sums, dataset_name)
        meter.iter_toc()
        weight = int(round(float(sums[2 * k])))  # the global batch's fixation frames
        meter.update_stats(f1, recall, precision, None, threshold, weight=weight)
        meter.log_iter_stats(cur_epoch, cur_iter)
        meter.iter_tic()

    done = 0
    with _weights(state.model, state.ema), loader_lib.DevicePrefetcher(
            iter(val_loader), device, depth=cfg.DATA_LOADER.PREFETCH_DEPTH) as prefetch:
        for batch in prefetch:
            meter.data_toc()
            preds = eval_step(state.model, batch)
            record(done, metrics.f1_sums(metrics.minmax_rescale(preds), batch["labels_hm"],
                                         batch["labels"], dataset_name))
            done += 1
        sharded = isinstance(next(state.model.parameters()), collectives.DTensor)
        for cur_iter in range(done, val_loader.batch_sampler.num_batches()):
            meter.data_toc()
            if sharded:
                eval_step(state.model, _first_row(val_loader, cur_epoch, device))
            record(cur_iter, torch.zeros(2 * k + 1, device=device))
    meter.log_epoch_stats(cur_epoch)
    meter.reset()

"""Training, validation and test meters (``csts_tpu/train/meters.py``;
reference ``slowfast/utils/meters.py:23-530``): windowed medians for the
iteration records, sample-weighted (train) and fixation-weighted (val)
epoch aggregates, the ETA, the whole-test-set gaze meter with multi-view
ensembling, and the epoch timer. ``json_stats`` records of types
"train_iter", "train_epoch", "val_iter", "val_epoch", "test_iter" and
"test_final", with the JAX package's keys.
"""

from __future__ import annotations

import datetime
import time
from collections import deque
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from csts_torch.eval.metrics import StreamingF1
from csts_torch.utils.logging import log_json_stats
from csts_torch.utils.misc import mem_fields


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self._paused = None
        self._total = 0.0

    def pause(self):
        if self._paused is None:
            self._total += time.perf_counter() - self._start
            self._paused = True

    def resume(self):
        self._start = time.perf_counter()
        self._paused = None

    def seconds(self) -> float:
        if self._paused is None:
            return self._total + (time.perf_counter() - self._start)
        return self._total


class ScalarMeter:
    """Windowed scalar tracker (fvcore's, as the JAX package keeps it)."""

    def __init__(self, window_size: int = 10):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def reset(self):
        self.deque.clear()
        self.total = 0.0
        self.count = 0

    def add_value(self, value: float):
        self.deque.append(value)
        self.count += 1
        self.total += value

    def get_win_median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    def get_global_avg(self) -> float:
        return self.total / max(self.count, 1)


def _eta(seconds_per_iter: float, iters_left: int) -> str:
    return str(datetime.timedelta(seconds=int(seconds_per_iter * max(iters_left, 0))))


class _Timed:
    """The iteration, data and net timers every meter keeps."""

    def _init_timers(self):
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()

    def iter_tic(self):
        self.iter_timer.reset()
        self.data_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()
        self.net_timer.pause()

    def data_toc(self):
        self.data_timer.pause()
        self.net_timer.reset()


class TrainGazeMeter(_Timed):
    """Training records (meters.py:200-339): per LOG_PERIOD iterations the
    window's medians ("train_iter"), per epoch the sample-weighted means
    ("train_epoch"). ``device`` is where the memory fields read from."""

    def __init__(self, epoch_iters: int, cfg, device=None):
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else None
        self.epoch_iters = epoch_iters
        self.max_iter = cfg.SOLVER.MAX_EPOCH * epoch_iters
        self._init_timers()
        self.loss = ScalarMeter(cfg.LOG_PERIOD)
        self.f1 = ScalarMeter(cfg.LOG_PERIOD)
        self.recall = ScalarMeter(cfg.LOG_PERIOD)
        self.precision = ScalarMeter(cfg.LOG_PERIOD)
        self.lr = 0.0
        self.reset()

    def reset(self):
        self.loss_total = 0.0
        self.f1_total = 0.0
        self.recall_total = 0.0
        self.precision_total = 0.0
        self.num_samples = 0

    def update_stats(self, f1, recall, precision, threshold, loss, lr, mb_size):
        self.loss.add_value(loss)
        self.f1.add_value(f1)
        self.recall.add_value(recall)
        self.precision.add_value(precision)
        self.lr = lr
        self.loss_total += loss * mb_size
        self.f1_total += f1 * mb_size
        self.recall_total += recall * mb_size
        self.precision_total += precision * mb_size
        self.num_samples += mb_size

    def log_iter_stats(self, cur_epoch: int, cur_iter: int):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        iters_left = self.max_iter - (cur_epoch * self.epoch_iters + cur_iter + 1)
        log_json_stats({
            "_type": "train_iter",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.epoch_iters}",
            "dt": self.iter_timer.seconds(),
            "dt_data": self.data_timer.seconds(),
            "dt_net": self.net_timer.seconds(),
            "eta": _eta(self.iter_timer.seconds(), iters_left),
            "loss": self.loss.get_win_median(),
            "f1": self.f1.get_win_median(),
            "recall": self.recall.get_win_median(),
            "precision": self.precision.get_win_median(),
            "lr": self.lr,
            **mem_fields(self.device),
        })

    def log_epoch_stats(self, cur_epoch: int):
        n = max(self.num_samples, 1)
        log_json_stats({
            "_type": "train_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "loss": self.loss_total / n,
            "f1": self.f1_total / n,
            "recall": self.recall_total / n,
            "precision": self.precision_total / n,
            "lr": self.lr,
            **mem_fields(self.device, with_ram=True),
        })


class ValGazeMeter(_Timed):
    """Validation records (meters.py:342-475): the window's medians
    ("val_iter") and the epoch's means weighted by each batch's fixation
    frames ("val_epoch")."""

    def __init__(self, epoch_iters: int, cfg, device=None):
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else None
        self.epoch_iters = epoch_iters
        self._init_timers()
        self.f1 = ScalarMeter(cfg.LOG_PERIOD)
        self.recall = ScalarMeter(cfg.LOG_PERIOD)
        self.precision = ScalarMeter(cfg.LOG_PERIOD)
        self.reset()

    def reset(self):
        self.f1_total = 0.0
        self.recall_total = 0.0
        self.precision_total = 0.0
        self.num_fixations = 0

    def update_stats(self, f1, recall, precision, labels, threshold,
                     fixation_idx: int = 0, weight: Optional[int] = None):
        """``weight``: the batch's fixation-frame count, else counted from
        ``labels`` (B, T, 3)."""
        self.f1.add_value(f1)
        self.recall.add_value(recall)
        self.precision.add_value(precision)
        if weight is None:
            weight = int((_host(labels)[:, :, 2] == fixation_idx).sum())
        self.f1_total += f1 * weight
        self.recall_total += recall * weight
        self.precision_total += precision * weight
        self.num_fixations += weight

    def log_iter_stats(self, cur_epoch: int, cur_iter: int):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        log_json_stats({
            "_type": "val_iter",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.epoch_iters}",
            "dt": self.iter_timer.seconds(),
            "f1": self.f1.get_win_median(),
            "recall": self.recall.get_win_median(),
            "precision": self.precision.get_win_median(),
            **mem_fields(self.device),
        })

    def log_epoch_stats(self, cur_epoch: int):
        n = max(self.num_fixations, 1)
        log_json_stats({
            "_type": "val_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.SOLVER.MAX_EPOCH}",
            "f1": self.f1_total / n,
            "recall": self.recall_total / n,
            "precision": self.precision_total / n,
            **mem_fields(self.device, with_ram=True),
        })


class EpochTimer:
    """Seconds per epoch (meters.py:478-530)."""

    def __init__(self):
        self.timer = Timer()
        self.epoch_times = []

    def reset(self):
        self.epoch_times = []

    def epoch_tic(self):
        self.timer.reset()

    def epoch_toc(self):
        self.timer.pause()
        self.epoch_times.append(self.timer.seconds())

    def last_epoch_time(self):
        return self.epoch_times[-1]

    def avg_epoch_time(self):
        return float(np.mean(self.epoch_times))

    def median_epoch_time(self):
        return float(np.median(self.epoch_times))


def _host(x) -> np.ndarray:
    """A tensor (any dtype, any device) or array as a numpy array; bf16
    becomes float32, which holds every bf16 value exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class TestGazeMeter(_Timed):
    """Whole-test-set metrics through the streaming accumulator (O(thresholds)
    state, AUC included).

    ``num_views`` > 1 ensembles the views of a clip (NUM_ENSEMBLE_VIEWS ×
    NUM_SPATIAL_CROPS): the dataset expands each clip into ``num_views``
    consecutive indices; a clip's views are averaged in float64 on the host
    and enter the metric as float32, with the first view's labels. Views are
    grouped by ``index // num_views``. A dataset index seen before (a
    repeated row) is dropped, at one view and at several.
    """

    __test__ = False  # not a pytest class

    def __init__(self, dataset: str, num_views: int = 1, device=None):
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.stream = StreamingF1(dataset, self.device)
        self.num_views = max(1, int(num_views))
        self._pending: Dict[int, Dict[int, tuple]] = {}
        self._done: set = set()
        self._init_timers()
        self.stats: Optional[Dict] = None

    def update_stats(self, preds, labels_hm, labels, indices: Optional[Iterable[int]] = None):
        """One batch: ``preds`` (B, T, H, W) rescaled, ``labels_hm`` (B, T, H, W),
        ``labels`` (B, T, 3), ``indices`` the rows' dataset indices."""
        if indices is None:
            self.stream.update(preds, labels_hm, labels)
            return
        indices = [int(i) for i in _host(indices)]
        if self.num_views == 1:
            fresh = []
            for i in indices:
                fresh.append(i not in self._done)
                self._done.add(i)
            if not all(fresh):
                keep = torch.tensor([j for j, f in enumerate(fresh) if f], dtype=torch.long)
                preds, labels_hm, labels = (
                    x[keep.to(x.device)] if isinstance(x, torch.Tensor) else np.asarray(x)[keep.numpy()]
                    for x in (preds, labels_hm, labels))
            if any(fresh):
                self.stream.update(preds, labels_hm, labels)
            return
        preds, labels_hm, labels = _host(preds), _host(labels_hm), _host(labels)
        for row, idx in enumerate(indices):
            cid, view = divmod(idx, self.num_views)
            if cid in self._done:
                continue  # a repeat of a finished clip
            views = self._pending.setdefault(cid, {})
            views[view] = (preds[row], labels_hm[row], labels[row])
            if len(views) == self.num_views:
                self._flush(cid)

    def _flush(self, cid: int) -> None:
        views = self._pending.pop(cid)
        order = sorted(views)
        pred = np.mean([views[v][0] for v in order], axis=0, dtype=np.float64)
        _, labels_hm, labels = views[order[0]]
        self._done.add(cid)
        self.stream.update(pred[None].astype(np.float32), labels_hm[None], labels[None])

    def flush_pending(self) -> None:
        """Score the clips whose views did not all arrive, on the views they have."""
        for cid in sorted(self._pending):
            self._flush(cid)

    def log_iter_stats(self, cur_iter: int, log_period: int = 10):
        if (cur_iter + 1) % log_period != 0:
            return
        log_json_stats({
            "_type": "test_iter",
            "cur_iter": cur_iter + 1,
            "dt": self.iter_timer.seconds(),
            **mem_fields(self.device),
        })

    def finalize_metrics(self, other_states: Iterable[dict] = ()) -> Dict:
        """The "test_final" record. Pending clips are flushed first, then the
        states of other accumulators (``StreamingF1.state``) merge in: the JAX
        tester merges before it flushes (``csts_tpu/eval/tester.py:263``)."""
        self.flush_pending()
        for state in other_states:
            self.stream.merge_state(state)
        result = self.stream.finalize()
        self.stats = {"_type": "test_final", **result, **mem_fields(self.device, with_ram=True)}
        log_json_stats(self.stats)
        return self.stats

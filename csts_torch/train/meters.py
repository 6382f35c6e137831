"""Test meters (``csts_tpu/train/meters.py``; reference
``slowfast/utils/meters.py:23-197``): windowed scalars, timers, and the
whole-test-set gaze meter with multi-view ensembling. ``json_stats`` records
of types "test_iter" and "test_final". The train and val meters come with
the trainer (ROADMAP A.6).
"""

from __future__ import annotations

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


def _host(x) -> np.ndarray:
    """A tensor (any dtype, any device) or array as a numpy array; bf16
    becomes float32, which holds every bf16 value exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class TestGazeMeter:
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
        self.iter_timer = Timer()
        self.data_timer = Timer()
        self.net_timer = Timer()
        self.stats: Optional[Dict] = None

    def iter_tic(self):
        self.iter_timer.reset()
        self.data_timer.reset()

    def iter_toc(self):
        self.iter_timer.pause()
        self.net_timer.pause()

    def data_toc(self):
        self.data_timer.pause()
        self.net_timer.reset()

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

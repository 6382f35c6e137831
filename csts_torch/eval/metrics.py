"""Gaze evaluation metrics: adaptive-threshold F1 (+recall/precision) and AUC,
on the device's tensors (``csts_tpu/eval/metrics.py``; reference
``slowfast/utils/metrics.py:9-74``).

The JAX package's semantics are kept, dtypes included:

* each threshold keeps only (B, T) partial sums; the fixation-frame masking is
  a weighted mean (the reference's ``index_select``, same value);
* the threshold grid is cast to the predictions' dtype before the compare
  (bf16 under MIXED_PRECISION, where the rounded grid decides which pixels
  pass), and :func:`minmax_rescale` runs in that dtype;
* AUC (Mann-Whitney, per fixation frame) ranks pixels by a stable argsort,
  so tied predictions (bf16 heatmaps rescaled to [0, 1] tie) take the ranks
  ``jnp.argsort`` gives them, and the ranks are held in the predictions'
  dtype as the JAX package holds them (bf16 ranks above 256 round);
* :class:`StreamingF1` accumulates each batch's partial sums in float64 on
  the host, in a state that other accumulators' states merge into.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Dataset-specific threshold grids (metrics.py:35-43).
_EGO4D_FORECAST = tuple(np.linspace(0.01, 0.07, 31))
_ARIA_FORECAST = tuple(np.linspace(0.0, 0.02, 21))
_ESTIMATION = tuple(np.linspace(0.0, 0.02, 11))

_FIXATION_IDX = {
    "egteagaze": 1,
    "ego4dgaze": 0, "ego4dgaze_forecast": 0, "ego4d_av_gaze": 0,
    "ego4d_av_gaze_forecast": 0, "aria_gaze": 0, "aria_gaze_forecast": 0,
    "aria_av_gaze": 0, "aria_av_gaze_forecast": 0,
}


def thresholds_for(dataset: str) -> Tuple[float, ...]:
    if "forecast" in dataset and "aria" not in dataset:
        return _EGO4D_FORECAST
    if "forecast" in dataset and "aria" in dataset:
        return _ARIA_FORECAST
    return _ESTIMATION


def fixation_index(dataset: str) -> int:
    if dataset not in _FIXATION_IDX:
        raise NotImplementedError(f"Metrics of {dataset} is not implemented.")
    return _FIXATION_IDX[dataset]


def _frames(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W) from (B, T, H, W) or (B, T, H, W, 1)."""
    return x[..., 0] if x.ndim == 5 else x


def minmax_rescale(preds: torch.Tensor) -> torch.Tensor:
    """Per-frame min-max rescale applied before adaptive_f1
    (train_avgaze_net.py:125-127), in the predictions' dtype."""
    if preds.ndim == 5:
        preds = preds[..., 0] if preds.shape[-1] == 1 else preds.squeeze(1)
    b, t, h, w = preds.shape
    flat = preds.reshape(b, t, h * w)
    lo = flat.amin(dim=-1, keepdim=True)
    hi = flat.amax(dim=-1, keepdim=True)
    return ((flat - lo) / (hi - lo + 1e-6)).reshape(b, t, h, w)


def f1_counts(
    preds: torch.Tensor, labels_hm: torch.Tensor, thresholds: Tuple[float, ...]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-(threshold, sample, frame) counts: tp (K, B, T), fg_labels (B, T),
    fg_preds (K, B, T), float32. ``preds`` (B, T, H, W) rescaled to [0, 1]."""
    preds, labels_hm = _frames(preds), _frames(labels_hm)
    th = torch.tensor(thresholds, dtype=torch.float64).to(preds.dtype).to(preds.device)
    binary_labels = (labels_hm > 0.001).float()
    fg_labels = binary_labels.sum(dim=(2, 3))
    binary_preds = (preds[None] > th[:, None, None, None, None]).float()
    tp = (binary_preds * binary_labels[None]).sum(dim=(3, 4))
    fg_preds = binary_preds.sum(dim=(3, 4))
    return tp, fg_labels, fg_preds


def _ratio_sums(preds, labels_hm, labels, thresholds, fix_idx):
    """Per-threshold sums over fixation frames of recall and precision, and
    the fixation-frame count (float32 on the device)."""
    tp, fg_labels, fg_preds = f1_counts(preds, labels_hm, thresholds)
    mask = (labels[:, :, 2] == fix_idx).float()
    r_sum = ((tp / (fg_labels[None] + 1e-6)) * mask[None]).sum(dim=(1, 2))
    p_sum = ((tp / (fg_preds + 1e-6)) * mask[None]).sum(dim=(1, 2))
    return r_sum, p_sum, mask.sum(), mask


def f1_sums(preds: torch.Tensor, labels_hm: torch.Tensor, labels: torch.Tensor,
            dataset: str) -> torch.Tensor:
    """One batch's partial sums of :func:`adaptive_f1` as one float32 tensor
    on the device: the per-threshold recall and precision sums over the
    fixation frames, then their count. Sums of several batches (or ranks)
    add."""
    r_sum, p_sum, cnt, _ = _ratio_sums(preds, labels_hm, labels, thresholds_for(dataset),
                                       fixation_index(dataset))
    return torch.cat([r_sum, p_sum, cnt[None]])


def best_f1(sums: torch.Tensor, dataset: str) -> Tuple[float, float, float, float]:
    """The best-threshold (f1, recall, precision, threshold) of
    :func:`f1_sums`' sums."""
    thresholds = thresholds_for(dataset)
    k = len(thresholds)
    denom = sums[2 * k] + 1e-12
    recall, precision = sums[:k] / denom, sums[k:2 * k] / denom
    f1 = (2 * recall * precision) / (recall + precision + 1e-6)
    i = int(torch.argmax(f1))
    return float(f1[i]), float(recall[i]), float(precision[i]), float(thresholds[i])


def adaptive_f1(
    preds: torch.Tensor, labels_hm: torch.Tensor, labels: torch.Tensor, dataset: str,
) -> Tuple[float, float, float, float]:
    """Best-threshold (f1, recall, precision, threshold) over the fixation
    frames of one batch (metrics.py:9-74). ``preds`` (B, T, H, W) min-max
    rescaled; ``labels_hm`` (B, T, H, W); ``labels`` (B, T, 3) [x, y, type]."""
    return best_f1(f1_sums(preds, labels_hm, labels, dataset), dataset)


def auc_per_frame(preds: torch.Tensor, labels_hm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """ROC-AUC of each frame's heatmap against the binarized label (B, T).

    Mann-Whitney: AUC = (rank sum of the positives - n_pos(n_pos+1)/2) /
    (n_pos · n_neg), with 1-based ranks from a stable argsort (ties ranked in
    pixel order) held in the predictions' dtype. Returns (auc, valid), float32,
    where valid = 0 for frames with no positives.
    """
    preds, labels_hm = _frames(preds), _frames(labels_hm)
    b, t, h, w = preds.shape
    p = preds.reshape(b, t, h * w)
    pos = (labels_hm.reshape(b, t, h * w) > 0.001).float()
    n_pos = pos.sum(dim=-1)
    n_neg = (h * w) - n_pos
    order = torch.argsort(p, dim=-1, stable=True)
    ranks = (torch.arange(h * w, device=p.device).to(p.dtype) + 1.0).expand_as(p)
    base_rank = torch.zeros_like(p).scatter_(-1, order, ranks)
    rank_sum_pos = (base_rank.float() * pos).sum(dim=-1)
    auc = (rank_sum_pos - n_pos * (n_pos + 1) / 2.0) / torch.clamp(n_pos * n_neg, min=1.0)
    return auc, (n_pos > 0).float()


class StreamingF1:
    """Whole-test-set adaptive F1 and AUC from per-batch partial sums
    (TestGazeMeter.finalize, meters.py:132-146, without keeping every
    prediction). ``update`` takes device tensors (or numpy arrays, moved to
    ``device``); the sums are float64 on the host."""

    def __init__(self, dataset: str, device=None):
        self.dataset = dataset
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.thresholds = thresholds_for(dataset)
        self.fix_idx = fixation_index(dataset)
        k = len(self.thresholds)
        self._recall_sum = np.zeros((k,), np.float64)
        self._precision_sum = np.zeros((k,), np.float64)
        self._count = 0.0
        self._auc_sum = 0.0
        self._auc_count = 0.0

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    def update(self, preds, labels_hm, labels) -> None:
        """``preds`` (B, T, H, W) rescaled."""
        preds, labels_hm, labels = (self._tensor(x) for x in (preds, labels_hm, labels))
        r_sum, p_sum, cnt, mask = _ratio_sums(preds, labels_hm, labels, self.thresholds,
                                              self.fix_idx)
        auc, valid = auc_per_frame(preds, labels_hm)
        sums = torch.cat([r_sum, p_sum, torch.stack([
            cnt, (auc * valid * mask).sum(), (valid * mask).sum()])]).double().cpu().numpy()
        k = len(self.thresholds)
        self._recall_sum += sums[:k]
        self._precision_sum += sums[k : 2 * k]
        self._count += float(sums[2 * k])
        self._auc_sum += float(sums[2 * k + 1])
        self._auc_count += float(sums[2 * k + 2])

    def state(self) -> dict:
        """The mergeable partial sums (pickleable)."""
        return {
            "recall_sum": self._recall_sum.copy(),
            "precision_sum": self._precision_sum.copy(),
            "count": self._count,
            "auc_sum": self._auc_sum,
            "auc_count": self._auc_count,
        }

    def merge_state(self, other: dict) -> None:
        """Fold another accumulator's :meth:`state` into this one."""
        self._recall_sum += np.asarray(other["recall_sum"])
        self._precision_sum += np.asarray(other["precision_sum"])
        self._count += float(other["count"])
        self._auc_sum += float(other["auc_sum"])
        self._auc_count += float(other["auc_count"])

    def finalize(self) -> dict:
        recall = self._recall_sum / max(self._count, 1e-12)
        precision = self._precision_sum / max(self._count, 1e-12)
        f1 = (2 * recall * precision) / (recall + precision + 1e-6)
        i = int(np.argmax(f1))
        auc = self._auc_sum / max(self._auc_count, 1e-12)
        return {
            "f1": float(f1[i]),
            "recall": float(recall[i]),
            "precision": float(precision[i]),
            "threshold": float(self.thresholds[i]),
            "auc": float(auc),
        }

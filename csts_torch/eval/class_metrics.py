"""Classification metrics for the MViT family (``csts_tpu/eval/class_metrics.py``):
top-k accuracy and the confusion matrix.

Reference: ``slowfast/utils/metrics.py`` upstream ``topks_correct`` (dropped in
the CSTS fork) and ``slowfast/visualization/utils.py:158-254``. The two ``plot_*`` functions
draw with matplotlib in the JAX module, which the card's machine lacks: here
they keep its path without matplotlib and return None (no figure, no file).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def _total_order(preds: torch.Tensor) -> torch.Tensor:
    """int32 keys that rank fp32 scores in IEEE total order (−0.0 below
    +0.0, NaN above +inf), the order ``jax.lax.top_k`` ranks them in."""
    bits = preds.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def topks_correct(preds: torch.Tensor, labels: torch.Tensor, ks: Sequence[int]) -> List[torch.Tensor]:
    """Number of top-k correct predictions per k. preds (B, C), labels (B,).
    Scores rank in IEEE total order and equal scores rank the lower class
    first, as ``jax.lax.top_k`` does."""
    max_k = max(ks)
    top_idx = torch.sort(_total_order(preds), dim=1, descending=True,
                         stable=True).indices[:, :max_k]
    correct = top_idx == labels.reshape(-1, 1).to(top_idx.dtype)
    return [correct[:, :k].any(dim=1).sum() for k in ks]


def topk_accuracies(preds, labels, ks: Sequence[int] = (1, 5)) -> List[float]:
    """Top-k accuracies in percent; preds and labels as tensors or arrays."""
    preds, labels = torch.as_tensor(preds), torch.as_tensor(labels)
    n = preds.shape[0]
    return [float(c) / n * 100.0 for c in topks_correct(preds, labels, ks)]


def topk_errors(preds, labels, ks: Sequence[int] = (1, 5)) -> List[float]:
    return [100.0 - a for a in topk_accuracies(preds, labels, ks)]


def confusion_matrix(preds, labels, num_classes: int) -> np.ndarray:
    """(num_classes, num_classes) counts, rows the true class; ``preds``
    scores (B, C) or predicted classes (B,)."""
    preds = np.asarray(preds)
    pred_cls = preds.argmax(axis=-1) if preds.ndim > 1 else preds
    labels = np.asarray(labels).astype(np.int64)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (labels, pred_cls.astype(np.int64)), 1)
    return cm


def plot_topk_histogram(class_name, counts, k: int = 10, class_names=None, path: str = None):
    """The JAX function's path without matplotlib
    (``csts_tpu/eval/class_metrics.py:42-53``): no figure, None."""
    return None


def plot_confusion_matrix(cm, class_names=None, path: str = None):
    """The JAX function's path without matplotlib
    (``csts_tpu/eval/class_metrics.py:69-76``): no figure, None."""
    return None

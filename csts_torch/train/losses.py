"""Loss functions (``csts_tpu/train/losses.py``; reference
``slowfast/models/losses.py`` and ``utils/utils.py:5-24``).

Heatmap tensors are channels-last ``(B, T, H, W[, 1])``; embedding tensors
``(B, D)``. The composite ``kldiv+egonce`` objective is assembled in the
train step (``csts_torch/train/step.py``), as the reference assembles it
inline, with the EgoNCE similarity over the whole batch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def frame_softmax(logits: torch.Tensor, temperature: float = 2.0) -> torch.Tensor:
    """Per-frame spatial softmax (utils/utils.py:5-12). (B,T,H,W,C) -> same shape.
    The division runs in the logits' dtype, the softmax in fp32."""
    b, t, h, w, c = logits.shape
    flat = logits.reshape(b, t, h * w, c) / temperature
    probs = torch.softmax(flat.float(), dim=2).to(logits.dtype)
    return probs.reshape(b, t, h, w, c)


def sim_matrix(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Cosine-similarity matrix (utils/utils.py:15-24), the product in fp32."""
    a_norm = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=eps)
    b_norm = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=eps)
    return torch.matmul(a_norm.float(), b_norm.float().t())


def kldiv_loss(pred: torch.Tensor, target: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL divergence over per-frame heatmaps, normalised by T·log(HW) (losses.py:51-82).

    ``pred``: per-frame probability maps (B, T, H, W) or (B, T, H, W, 1),
    already through :func:`frame_softmax`. ``target`` ditto (or None for the
    uniform prior)."""
    if pred.dim() == 5:
        pred = pred[..., 0]
    b, t, h, w = pred.shape
    p = pred.reshape(b, t, h * w).float()
    log_p = torch.log(p + 1e-10)
    if target is None:
        kl = (p * log_p).sum(dim=-1) - math.log(1.0 / (h * w))
    else:
        if target.dim() == 5:
            target = target[..., 0]
        q = target.reshape(b, t, h * w).float()
        kl = (p * log_p).sum(dim=-1) - (p * torch.log(q + 1e-10)).sum(dim=-1)
    return (kl.sum(dim=-1) / (t * math.log(float(h * w)))).mean()


def egonce_loss(sim: torch.Tensor, temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE on a similarity matrix (losses.py:152-170)."""
    i_sm = torch.softmax(sim / temperature, dim=1)
    j_sm = torch.softmax(sim.t() / temperature, dim=1)
    return -torch.log(torch.diagonal(i_sm)).mean() - torch.log(torch.diagonal(j_sm)).mean()


def soft_target_cross_entropy(x: torch.Tensor, y: torch.Tensor,
                              reduction: str = "mean") -> torch.Tensor:
    """(losses.py:12-33)"""
    loss = (-y * F.log_softmax(x, dim=-1)).sum(dim=-1)
    return loss.mean() if reduction == "mean" else loss


def weighted_bce_with_logits(x: torch.Tensor, y: torch.Tensor, pos_weight: float = 5.0,
                             reduction: str = "mean") -> torch.Tensor:
    """5×-positive-weighted BCE (losses.py:36-48)."""
    loss = -(pos_weight * y * F.logsigmoid(x) + (1 - y) * torch.log1p(-torch.sigmoid(x)))
    return loss.mean() if reduction == "mean" else loss


def bce_loss(p: torch.Tensor, y: torch.Tensor,
             weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    eps = 1e-12
    loss = -(y * torch.log(p + eps) + (1 - y) * torch.log(1 - p + eps))
    if weight is not None:
        loss = loss * weight
    return loss.mean()


def _floss_weight(target: torch.Tensor) -> torch.Tensor:
    """Distance-to-peak reciprocal weight map (losses.py:125-149): 1 / ((d + 1) / W)
    with d the distance to the mean position of the frame's maxima."""
    b, t, h, w = target.shape
    flat = target.reshape(b, t, h * w)
    is_max = (flat == flat.amax(dim=-1, keepdim=True)).float()
    idx = torch.arange(h * w, dtype=torch.float32, device=target.device)
    denom = is_max.sum(dim=-1)
    mean_row = (is_max * torch.div(idx, w, rounding_mode="floor")).sum(dim=-1) / denom
    mean_col = (is_max * torch.remainder(idx, w)).sum(dim=-1) / denom
    rows = torch.arange(h, dtype=torch.float32, device=target.device)[None, None, :, None]
    cols = torch.arange(w, dtype=torch.float32, device=target.device)[None, None, None, :]
    dist = torch.sqrt((rows - mean_row[:, :, None, None]) ** 2
                      + (cols - mean_col[:, :, None, None]) ** 2)
    return 1.0 / ((dist + 1.0) / w)


def floss(pred_sigmoid: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distance-weighted BCE (losses.py:85-95)."""
    if pred_sigmoid.dim() == 5:
        pred_sigmoid = pred_sigmoid[..., 0]
    if target.dim() == 5:
        target = target[..., 0]
    return bce_loss(pred_sigmoid, target, _floss_weight(target))


def kldiv_plus_floss(logits: torch.Tensor, target: torch.Tensor,
                     alpha: float = 1.0) -> torch.Tensor:
    """(losses.py:173-183)"""
    kld = kldiv_loss(frame_softmax(logits, temperature=2.0), target)
    return kld + alpha * floss(torch.sigmoid(logits), target)


_LOSSES = {
    "kldiv": kldiv_loss,
    "egonce": egonce_loss,
    "floss": floss,
    "kldiv+floss": kldiv_plus_floss,
    "soft_cross_entropy": soft_target_cross_entropy,
    "bce_logit": weighted_bce_with_logits,
    "bce": bce_loss,
}


def get_loss_fn(name: str):
    """Loss registry (losses.py:187-207). ``kldiv+egonce`` is assembled in the
    train step."""
    if name not in _LOSSES:
        raise NotImplementedError(f"Loss {name} is not supported")
    return _LOSSES[name]

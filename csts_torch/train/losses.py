"""Losses (``csts_tpu/train/losses.py``). This part of the port carries only
what serving needs: the per-frame spatial softmax."""

from __future__ import annotations

import torch


def frame_softmax(logits: torch.Tensor, temperature: float = 2.0) -> torch.Tensor:
    """Per-frame spatial softmax (utils/utils.py:5-12). (B,T,H,W,C) -> same shape.
    The division runs in the logits' dtype, the softmax in fp32."""
    b, t, h, w, c = logits.shape
    flat = logits.reshape(b, t, h * w, c) / temperature
    probs = torch.softmax(flat.float(), dim=2).to(logits.dtype)
    return probs.reshape(b, t, h, w, c)

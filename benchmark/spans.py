"""What the readers of the program's spans share (``csts_torch.utils.tracing``).

The program records spans only while a profiler records, and a run's
profilers are those of :func:`benchmark.trace.traced_calls`: ``n`` calls
traced on the card alone, then ``max(1, n // 2)`` with the host's operations
traced too, which slows a host-bound loop. So the store holds both
stretches' spans, oldest first, and a reader keeps those of the first ``n``
calls alone. ``n`` is the context's ``traced_steps`` (``drivers/train.py``)
where it has one, else the one count of calls that ``traced_calls`` turns
into as many spans as the store holds. Every function returns None where
the program records no such span, or has no spans at all.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

STEP = "csts.train_step"


def first_calls(count: int) -> Optional[int]:
    """The ``n`` of a traced stretch of ``n`` calls after which
    ``traced_calls`` made ``count`` calls in all; None where no ``n`` does."""
    for n in range(count, 0, -1):
        if n + max(1, n // 2) == count:
            return n
    return None


def _records() -> List:
    try:
        from csts_torch.utils import tracing
    except ImportError:  # a program without spans
        return []
    return tracing.records()


def _card_only(ctx: Dict, spans: List) -> List:
    """The spans of the card-only stretch among one span a call, oldest first."""
    n = ctx.get("traced_steps") or first_calls(len(spans))
    return spans[:n] if n else []


def step_phase_ms(ctx: Dict, phase: str) -> Optional[float]:
    """Device ms a training step spends in the ``phase`` spans inside its
    ``csts.train_step`` span (summed: one a micro-batch), the median over
    the card-only stretch's steps."""
    if not ctx.get("train"):
        return None
    recs = _records()
    steps = {r.id for r in _card_only(ctx, [r for r in recs if r.name == STEP])}
    per_step: Dict[int, float] = {}
    for r in recs:
        if r.name == phase and r.parent in steps and r.device_ms is not None:
            per_step[r.parent] = per_step.get(r.parent, 0.0) + r.device_ms
    return statistics.median(per_step.values()) if per_step else None


def forward_stage_ms(ctx: Dict, stage: str) -> Optional[float]:
    """Device ms an eval forward spends in its ``stage`` span, the median
    over the card-only stretch's calls."""
    if not ctx.get("eval"):
        return None
    top = [r for r in _records() if r.name == stage and r.parent is None]
    ms = [r.device_ms for r in _card_only(ctx, top) if r.device_ms is not None]
    return statistics.median(ms) if ms else None

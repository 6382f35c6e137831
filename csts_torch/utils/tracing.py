"""Spans: named stretches of the program's work, recorded while a profiler records.

``with tracing.span("csts.train_step"):`` marks a stretch of the
program. A span records only while a ``torch.profiler`` is recording (the
benchmark's ``--trace 1`` window, the trainer's ``TRAIN.PROFILE_*`` window),
and never while a CUDA graph is being captured or ``torch.compile`` or
``torch.export`` traces the code. Otherwise it costs one flag read: no
``record_function``, no CUDA event, no allocation. It has no switch of its own.

While it records, a span opens a ``torch.profiler.record_function`` of its
name, so the span sits in the profiler's own trace, on that trace's clock,
its device annotation around the kernels it launched. It also keeps a
:class:`Record` in this process's store: its name, the span that encloses it,
the host clock at entry and exit (``time.perf_counter_ns``) and, once CUDA
is initialised, a pair of timing events recorded on the current stream at
entry and exit. Its device ms is the stream's time from
the first event to the second, idle time inside included; work the span
enqueues on another stream (a collective's) lies outside it.

:func:`records` reads the store, a ring of the last :data:`RING` spans;
:func:`clear` empties it. Each process has one store, so each rank has its own.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Deque, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

RING = 4096  # the records the store keeps, the oldest dropped first

_store: Deque["Record"] = collections.deque(maxlen=RING)
_ids = itertools.count()
_open = threading.local()  # .stack: the ids of this thread's open spans


@dataclasses.dataclass
class Record:
    """One closed span. ``parent``: the ``id`` of the span open around it
    on the same thread (None at the top). ``device_ms``: None where no
    CUDA events were recorded (on the CPU)."""

    id: int
    name: str
    parent: Optional[int]
    host_start_ns: int = 0
    host_end_ns: int = 0
    device_ms: Optional[float] = None
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e6


class _Span:
    __slots__ = ("name", "record", "function")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Record:
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        rec = self.record = Record(next(_ids), self.name, stack[-1] if stack else None)
        stack.append(rec.id)
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        if torch.cuda.is_initialized():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        rec.host_start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.record
        rec.host_end_ns = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        self.function.__exit__(*exc)
        _open.stack.pop()
        _store.append(rec)
        return False


_OFF = contextlib.nullcontext()  # the span of a run that records nothing: shared, stateless


def span(name: str):
    """A context manager that records the stretch it encloses as ``name``
    while a profiler records; see the module's docstring."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if torch.compiler.is_compiling() or (
            torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()):
        return _OFF
    return _Span(name)


def records() -> List[Record]:
    """The closed spans the store holds, oldest first. Where some still
    hold CUDA events, synchronises the card once and turns each pair into
    ``device_ms``. Reading does not clear the store."""
    recs = list(_store)
    pending = [r for r in recs if r.events is not None]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            r.device_ms = r.events[0].elapsed_time(r.events[1])
            r.events = None
    return recs


def clear() -> None:
    """Empties the store."""
    _store.clear()

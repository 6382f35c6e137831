"""Measurement tools of the port, the counterparts of the JAX package's
``tools/ab_block.py``, ``tools/ab_flags.py`` and ``tools/profile_forward.py``,
and three of its own: ``ab_kernels`` (K1, B4, B5, K2, B7 and B8 of two
checkouts in turns), ``b5_phases`` (B5's phase split from clock stamps) and
``tail_phases`` (K2's and B7's three kernels one by one, beside cuBLAS).
The first three run on CUDA unless given ``--device cpu`` (``python -m
csts_torch.tools.<name> --help``); a CPU run checks that the tool runs and
gives no device metric. The last three need a card."""

from __future__ import annotations

import subprocess
import time
from typing import Callable

import torch


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def mean_ms(fn: Callable[[], object], device: torch.device, iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters

"""Model statistics, memory reporting and the loader benchmark
(``csts_tpu/utils/misc.py``; reference ``slowfast/utils/misc.py:26-221`` and
``slowfast/utils/benchmark.py:20-103``)."""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from csts_torch.utils.logging import log_json_stats


def _tensors(params: Any):
    """The tensors of a module (its parameters), a state dict or a tree of
    dicts, lists and tuples."""
    if isinstance(params, torch.nn.Module):
        yield from params.parameters()
    elif isinstance(params, dict):
        for v in params.values():
            yield from _tensors(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            yield from _tensors(v)
    elif isinstance(params, torch.Tensor):
        yield params


def params_count(params: Any) -> int:
    """(misc.py:37-44)"""
    return int(sum(t.numel() for t in _tensors(params)))


def params_bytes(params: Any) -> int:
    return int(sum(t.numel() * t.element_size() for t in _tensors(params)))


def flops_count(fn, *example_args) -> float:
    """FLOPs of one call ``fn(*example_args)`` as ``torch.utils.flop_counter``
    counts them (replaces fvcore's tracing, misc.py:78-124): matrix products,
    convolutions and attention, 2 per multiply-add; elementwise work, norms
    and pools are not counted. It runs on the plain path (the kernels'
    plain twins, whose products the counter sees; a kernel's launch is
    opaque to it). The JAX package's ``flops_count`` reads XLA's cost
    analysis, which counts elementwise work too: the two numbers differ."""
    from torch.utils.flop_counter import FlopCounterMode

    from csts_torch.tools import plain_twins

    with plain_twins(), torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*example_args)
    return float(counter.get_total_flops())


def device_mem_usage(device: Optional[torch.device] = None) -> float:
    """Peak memory allocated on a CUDA device, in GB (misc.py:53-61's
    gpu_mem_usage). 0.0 for the CPU, which keeps no allocator statistics;
    the field stays in every record so the schema is stable."""
    if device is None or device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 1024**3


def cpu_mem_usage() -> tuple[float, float]:
    """Host RAM (used_gb, total_gb) from /proc/meminfo (misc.py:64-75, sans
    psutil: used = MemTotal - MemAvailable)."""
    total = avail = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
    except OSError:
        return 0.0, 0.0
    return (total - avail) / 1024**3, total / 1024**3


def mem_fields(device: Optional[torch.device] = None, with_ram: bool = False) -> Dict[str, str]:
    """The memory fields every meter record carries: per-iter records the
    device's memory, final records also host RAM."""
    fields = {"device_mem": "{:.2f}G".format(device_mem_usage(device))}
    if with_ram:
        fields["RAM"] = "{:.2f}/{:.2f}G".format(*cpu_mem_usage())
    return fields


def is_eval_epoch(cfg, cur_epoch: int) -> bool:
    """(misc.py:207-221)"""
    if cur_epoch + 1 == cfg.SOLVER.MAX_EPOCH:
        return True
    return (cur_epoch + 1) % cfg.TRAIN.EVAL_PERIOD == 0


def benchmark_data_loading(cfg, num_batches: int = 20) -> Dict[str, float]:
    """The host input pipeline's rate alone (benchmark.py:20-103): batches/s
    and clips/s of the train loader over up to ``num_batches`` batches
    after one warm-up batch (the workers' start), no device work. The loader
    is closed on return."""
    from csts_torch.data import loader as loader_lib

    with loader_lib.construct_loader(cfg, "train") as loader:
        loader.set_epoch(0)
        it = iter(loader)
        next(it)
        t0 = time.perf_counter()
        n = 0
        for _ in it:
            n += 1
            if n >= num_batches:
                break
        dt = time.perf_counter() - t0
        batch = loader.batch_sampler.local_batch_size
    stats = {"batches_per_sec": n / dt, "clips_per_sec": n * batch / dt,
             "batch_size": batch, "batches": n}
    log_json_stats({"_type": "data_benchmark", **stats})
    return stats

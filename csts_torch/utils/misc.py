"""Memory reporting for the meters' records (``csts_tpu/utils/misc.py:108``,
``mem_fields``; reference ``slowfast/utils/misc.py:53-75``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch


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

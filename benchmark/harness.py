"""One run of one cell: find its files by name, set up, measure, check,
and assemble the result line.

A cell is ``benchmark/workloads/<cell>.json`` (its configuration, driver,
traffic parameters, chips, why and limits), its configuration
``benchmark/configs/<config>.json``, its driver ``benchmark/drivers/<driver>.py``
(``setup``, ``window``, ``check``), and each metric that ``BENCHMARK.json``
lists for it a reader ``benchmark/metrics/<metric>.py`` (``read(ctx)``,
None where it finds nothing to read). A later cell, configuration, driver
or metric is a new file and an entry in ``BENCHMARK.json``; nothing here
names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

import torch

# modules that may not be loaded in a run, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "csts_tpu")
# where a run keeps what it caches, inside the checkout at fixed paths
CACHE_ENV = {
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "TRITON_CACHE_DIR": "triton",
    "TORCHINDUCTOR_CACHE_DIR": "inductor",
    "CUDA_CACHE_PATH": "cuda_compute",
}


class RunError(Exception):
    """A run that must exit without a result, with this message and code."""

    def __init__(self, message: str, code: int = 2):
        super().__init__(message)
        self.code = code


@dataclasses.dataclass
class Run:
    name: str
    cell: Dict
    config: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float = 0.0  # the process's start (perf_counter), for the set-up's marks

    def mark(self, what: str) -> None:
        """Logs on standard error how far into the process a step of set-up ended."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        print(f"# {what} {time.perf_counter() - self.t_start:.3f} s", file=sys.stderr, flush=True)

    @property
    def keys(self) -> Dict:
        """The configuration's keys, as its file sets them."""
        return self.config["set"]


def cache_dirs(root: str) -> None:
    for var, sub in CACHE_ENV.items():
        path = os.path.join(root, "build", "benchmark_cache", sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def find(root: str, kind: str, name: str, ext: str = ".json") -> str:
    """``benchmark/<kind>/<name><ext>`` under ``root``; raises where it is missing."""
    path = os.path.join(root, "benchmark", kind, name + ext)
    if not os.path.isfile(path):
        raise RunError(f"no {kind[:-1]} named {name!r} ({path})")
    return path


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: str) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_metrics(man: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics ``BENCHMARK.json`` gives this cell: with ``trace`` its
    per-layer ones, else its end-to-end ones."""
    rows = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in rows if "workloads" not in m or cell in m["workloads"]]


def read_metrics(root: str, rows: List[Dict], ctx: Dict) -> Dict[str, Dict]:
    out = {}
    for m in rows:
        mod = load_module(find(root, "metrics", m["name"], ".py"),
                          "benchmark_metric_" + m["name"].replace(".", "_").replace("-", "_"))
        value = mod.read(ctx)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def require_cards(n: int) -> None:
    if not torch.cuda.is_available():
        raise RunError("no CUDA card: the benchmark measures the port on the card only", 3)
    if torch.cuda.device_count() < n:
        raise RunError(f"the cell needs {n} cards, {torch.cuda.device_count()} present", 3)


def judge(readings: List[Dict]) -> bool:
    return all(r["value"] is not None and math.isfinite(r["value"]) and r["value"] <= r["limit"]
               for r in readings)


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: Optional[str] = None, log=None) -> Dict:
    """Runs cell ``name`` once and returns the result line's object (the
    ``checks`` key last). ``device``: None for the card (refused without
    one); a test names "cpu"."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cell = load_json(find(root, "workloads", name))
    config = load_json(find(root, "configs", cell["config"]))
    man = manifest(root)
    if device is None:
        require_cards(cell["chips"])
        device = "cuda"
        torch.cuda.init()
    log(f"# imports and the card {time.perf_counter() - t_start:.3f} s")
    run = Run(name, cell, config, int(seed), float(seconds), bool(trace), torch.device(device),
              t_start)
    driver = load_module(find(root, "drivers", cell["driver"], ".py"),
                         "benchmark_driver_" + cell["driver"])
    torch.set_num_threads(min(4, torch.get_num_threads()))
    state = driver.setup(run)
    try:
        setup_s = time.perf_counter() - t_start
        log(f"# set-up {setup_s:.3f} s")
        ctx = driver.window(run, state)
        ctx["setup_s"] = setup_s
        readings = driver.check(run, state, ctx)
    finally:
        if hasattr(driver, "close"):
            driver.close(state)
    limits = cell["limits"]
    for r in readings:
        r["limit"] = limits[r["name"]]
    bad = forbidden_modules()
    if bad:
        raise RunError(f"loaded in the run: {', '.join(bad)}", 4)
    metrics = read_metrics(root, cell_metrics(man, name, trace), ctx)
    dev = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
           "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                    else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": int(ctx.get("memory_peak_bytes", 0))}
    out = {"correct": judge(readings), "attempted": int(ctx["attempted"]),
           "failed": int(ctx["failed"]), "metrics": metrics, "device": dev}
    tr = ctx.get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        out["families_s"] = tr["families_s"]  # device seconds by kernel family, for PERF.md
    out["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]} for r in readings}
    return out

"""A copy of the benchmark with cells of the same drivers at the reduced
family members the CPU can run (crop 32, depth 4, width 16), for the tests."""

from __future__ import annotations

import copy
import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


SMALL_MVIT = {
    "DATA.TRAIN_CROP_SIZE": 32, "DATA.TEST_CROP_SIZE": 32, "DATA.AUDIO_FREQ_BINS": 32,
    "DATA.AUDIO_WINDOW": 32, "MVIT.DEPTH": 4, "MVIT.EMBED_DIM": 16,
    "MVIT.DIM_MUL": [[1, 2.0], [2, 2.0], [3, 2.0]], "MVIT.HEAD_MUL": [[1, 2.0], [2, 2.0], [3, 2.0]],
    "MVIT.POOL_Q_STRIDE": [[1, 1, 2, 2], [2, 1, 2, 2], [3, 1, 2, 2]],
}
# the serving cell left out of BENCHMARK.json until its tail is steady
# (PERF.md, Open questions): its file, driver and readers are kept and tested
SERVE = load(os.path.join(ROOT, "benchmark", "proposed", "csts_serve_open.json"))
SMALL = {  # cell -> (the cell it shrinks, config keys, traffic keys)
    "csts_small_eval": ("csts_eval_b32", {}, {"batch": 2, "pool": 2, "check_clips": 3,
                                              "warmup_calls": 1}),
    "csts_small_train": ("csts_train_b16", {}, {"batch": 2, "pool": 4}),
    "mvit_small_eval": ("mvit_k400_eval_b32", {"DATA.NUM_FRAMES": 8, "MODEL.NUM_CLASSES": 11},
                        {"batch": 2, "pool": 2, "check_clips": 3, "warmup_calls": 1}),
    "csts_small_serve": (SERVE, {}, {"rate_per_s": 20.0, "pool": 4, "check_requests": 4}),
}


def dump(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def small_config(name: str, extra: dict, fp32: bool = False) -> dict:
    cfg = copy.deepcopy(load(os.path.join(ROOT, "benchmark", "configs", name + ".json")))
    cfg["set"].update({k: v for k, v in SMALL_MVIT.items()
                       if cfg["model"] == "CSTS" or not k.startswith("DATA.AUDIO")})
    cfg["set"].update(extra)
    if fp32:
        cfg["set"]["TRAIN.MIXED_PRECISION"] = False
    return cfg


def checkout(tmp, fp32: bool = False) -> str:
    """A copy of BENCHMARK.json and benchmark/ under ``tmp`` with the
    :data:`SMALL` cells added (their configs ``<cell>_cfg``), in fp32 with
    ``fp32``."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = load(os.path.join(ROOT, "BENCHMARK.json"))
    for cell, (big, keys, traffic) in SMALL.items():
        c = copy.deepcopy(big) if isinstance(big, dict) else \
            load(os.path.join(root, "benchmark", "workloads", big + ".json"))
        dump(small_config(c["config"], keys, fp32),
             os.path.join(root, "benchmark", "configs", cell + "_cfg.json"))
        c["config"] = cell + "_cfg"
        c["traffic"].update(traffic)
        dump(c, os.path.join(root, "benchmark", "workloads", cell + ".json"))
        for rows in (man["end_to_end"], man["per_layer"]):
            for m in rows:
                if isinstance(big, str) and big in m.get("workloads", ()):
                    m["workloads"].append(cell)
    dump(man, os.path.join(root, "BENCHMARK.json"))
    return root

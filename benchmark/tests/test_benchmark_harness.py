"""The harness is driven by data: cells, configurations and metrics are
files found by name; the traffic is the same work from every seed; the
arithmetic of the end-to-end metrics covers every request and the whole
window; the manifest and the cell files agree."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from benchmark import harness, stats, traffic
from benchmark.tests import support

SEED = 2 ** 31 + 5


def test_manifest_and_cell_files_list_the_same_cells():
    man = support.load(os.path.join(support.ROOT, "BENCHMARK.json"))
    files = sorted(f[:-5] for f in os.listdir(os.path.join(support.ROOT, "benchmark", "workloads")))
    assert sorted(w["name"] for w in man["workloads"]) == files
    for w in man["workloads"]:
        cell = support.load(os.path.join(support.ROOT, "benchmark", "workloads", w["name"] + ".json"))
        assert (cell["config"], cell["traffic"]["name"], cell["chips"], cell["why"]) == \
            (w["config"], w["traffic"], w["chips"], w["why"])
        assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())
    for c in man["configs"]:
        cfg = support.load(os.path.join(support.ROOT, c["file"]))
        assert (cfg["source"], cfg["reduced"]) == (c["source"], c["reduced"])
    metrics = man["end_to_end"] + man["per_layer"]
    for m in metrics:
        assert os.path.isfile(os.path.join(support.ROOT, "benchmark", "metrics", m["name"] + ".py"))


def test_calibration_finds_benchmark_and_proposed_cells():
    calibrate = harness.load_module(os.path.join(support.ROOT, "benchmark", "calibrate.py"),
                                    "benchmark_calibrate")
    assert calibrate.cell_path(harness, "csts_eval_b32").endswith(
        os.path.join("workloads", "csts_eval_b32.json"))
    assert calibrate.cell_path(harness, "csts_serve_open").endswith(
        os.path.join("proposed", "csts_serve_open.json"))
    with pytest.raises(harness.RunError):
        calibrate.cell_path(harness, "no_such_cell")


def test_new_cell_config_and_metric_are_found_by_name(tmp_path):
    root = support.checkout(tmp_path)
    bench = os.path.join(root, "benchmark")
    cfg = support.load(os.path.join(bench, "configs", "csts_small_eval_cfg.json"))
    support.dump(cfg, os.path.join(bench, "configs", "dropped_cfg.json"))
    cell = support.load(os.path.join(bench, "workloads", "csts_small_eval.json"))
    cell["config"] = "dropped_cfg"
    support.dump(cell, os.path.join(bench, "workloads", "dropped_cell.json"))
    with open(os.path.join(bench, "metrics", "dropped_metric.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['clips'] + 0.5\n")
    man = support.load(os.path.join(root, "BENCHMARK.json"))
    man["end_to_end"].append({"name": "dropped_metric", "unit": "clips", "better": "higher",
                              "bound": 0.01, "source": "host_clock",
                              "workloads": ["dropped_cell"]})
    support.dump(man, os.path.join(root, "BENCHMARK.json"))
    out = harness.run_cell(root, "dropped_cell", SEED, 0.5, False, time.perf_counter(), "cpu")
    assert out["metrics"]["dropped_metric"]["value"] == out["attempted"] + 0.5
    assert "eval_clips_per_s" not in out["metrics"]  # listed for its own cells only
    assert list(out)[-1] == "checks" and out["correct"]


def test_open_loop_is_the_same_work_from_every_seed():
    a, b = traffic.open_loop(150.0, 20.0, SEED), traffic.open_loop(150.0, 20.0, SEED)
    assert np.array_equal(a, b)
    c = traffic.open_loop(150.0, 20.0, SEED + 1)
    assert len(a) == len(c) == 3000 and not np.array_equal(a, c)
    gaps = lambda d: np.sort(np.diff(np.append(d, 20.0)))  # noqa: E731
    assert np.allclose(gaps(a), gaps(c))
    assert a[0] == 0.0 and a[-1] < 20.0
    # the gaps are those of Poisson arrivals at the rate
    assert np.mean(np.diff(a)) == pytest.approx(1 / 150.0, rel=0.01)
    assert np.std(np.diff(a)) == pytest.approx(1 / 150.0, rel=0.05)


def test_seeds_draw_the_same_sizes_and_other_values():
    import torch

    x = traffic.clips(2, 2, 8, 8, 8, traffic.generator(SEED, "inputs"), torch.float32)
    y = traffic.clips(2, 2, 8, 8, 8, traffic.generator(SEED, "inputs"), torch.float32)
    z = traffic.clips(2, 2, 8, 8, 8, traffic.generator(SEED + 1, "inputs"), torch.float32)
    assert torch.equal(x["video"], y["video"]) and not torch.equal(x["video"], z["video"])
    hm = traffic.gaze_heatmaps(2, 3, 16, 19, traffic.generator(SEED, "labels"))
    assert torch.allclose(hm.sum((2, 3)), torch.ones(2, 3))
    assert traffic.sample(100, 7, SEED) == traffic.sample(100, 7, SEED)
    assert traffic.subseed(2 ** 40, "weights") != traffic.subseed(2 ** 40, "inputs")


def test_percentile_and_rate_over_every_request_and_the_window():
    lat = list(np.random.default_rng(0).exponential(50.0, size=1001))
    assert stats.percentile(lat, 95) == pytest.approx(np.percentile(lat, 95))
    assert stats.percentile(lat, 50) == pytest.approx(np.percentile(lat, 50))
    # a failed request counts as infinitely late: 6% of them move the p95 to inf
    failed = lat[:940] + [math.inf] * 61
    assert stats.percentile(failed, 95) == math.inf
    assert math.isfinite(stats.percentile(lat[:980] + [math.inf] * 21, 95))
    assert stats.rate(320, 0.8) == 400.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_jax_in_the_process_refuses_the_run(tmp_path, monkeypatch):
    root = support.checkout(tmp_path)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.RunError) as err:
        harness.run_cell(root, "csts_small_eval", SEED, 0.2, False, time.perf_counter(), "cpu")
    assert err.value.code != 0 and "jax" in str(err.value)


def test_without_a_card_the_command_prints_no_result():
    # this machine has no CUDA card: the run exits non-zero before any work
    proc = subprocess.run([sys.executable, os.path.join(support.ROOT, "benchmark", "run.py"),
                           "--workload", "csts_eval_b32", "--seed", str(SEED), "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=300,
                          cwd=support.ROOT)
    if proc.returncode == 0 and "cuda" in proc.stderr.lower():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "card" in proc.stderr


def test_result_line_keeps_checks_last_and_names_its_limits(tmp_path):
    root = support.checkout(tmp_path)
    out = harness.run_cell(root, "mvit_small_eval", SEED, 0.3, False, time.perf_counter(), "cpu")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"eval_clips_per_s", "setup_s"}
    assert out["checks"]["logit_gap"]["limit"] == support.load(os.path.join(
        support.ROOT, "benchmark", "workloads", "mvit_k400_eval_b32.json"))["limits"]["logit_gap"]
    json.dumps(out, allow_nan=False)

"""The measurements the benchmark's limits and the serving cell's rate were
set from, on the card, each cell's many seeds in one process:

    python3 benchmark/calibrate.py readings --workload <cell> --seeds 1 2 3 \
        [--seconds 3] [--controls fp8 half dump] [--out PATH]
    python3 benchmark/calibrate.py sweep --workload csts_serve_open \
        --rates 100 140 180 [--seconds 20] [--out PATH]

A cell is looked up in ``benchmark/workloads/`` and then in
``benchmark/proposed/``, which holds cells kept out of ``BENCHMARK.json``
(the serving cell, PERF.md §7) so that they can be measured and tested.

``readings``: per seed, the cell's set-up, a short window at its own load
and its check, with the readings of each control beside the program's
(``fp8``: the reference in fp8 in the program's place; ``half``: for
training, the reference with half of each batch left out; ``dump``: for
training, each side's losses and per-leaf norms, written to ``--out``
only). ``sweep``: the serving cell's window at each offered rate, with the
p50, p95 and p99, the clips completed per second, the generator's lateness, and whether the
backlog grew (the latency of the window's last fifth over its first's).
Each writes JSON to ``--out`` and prints a line a seed or rate.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cell_path(harness, name: str) -> str:
    """The cell's file: ``workloads/<name>.json``, else ``proposed/<name>.json``."""
    try:
        return harness.find(ROOT, "workloads", name)
    except harness.RunError:
        return harness.find(ROOT, "proposed", name)


def _run(harness, name: str, seed: int, seconds: float):
    cell = harness.load_json(cell_path(harness, name))
    config = harness.load_json(harness.find(ROOT, "configs", cell["config"]))
    harness.require_cards(cell["chips"])
    import torch

    run = harness.Run(name, cell, config, seed, seconds, False, torch.device("cuda"), T_START)
    driver = harness.load_module(harness.find(ROOT, "drivers", cell["driver"], ".py"),
                                 "benchmark_driver_" + cell["driver"])
    return run, driver


def readings(harness, args) -> list:
    rows = []
    for seed in args.seeds:
        run, driver = _run(harness, args.workload, seed, args.seconds)
        t = time.perf_counter()
        st = driver.setup(run)
        try:
            ctx = driver.window(run, st)
            got = driver.check(run, st, ctx, controls=tuple(args.controls))
        finally:
            if hasattr(driver, "close"):
                driver.close(st)
        row = {"seed": seed, "seconds": time.perf_counter() - t,
               **{r["name"]: r["value"] for r in got}}
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if not k.startswith("dump.")}), flush=True)
    return rows


def sweep(harness, args) -> list:
    from benchmark import stats, traffic

    run, driver = _run(harness, args.workload, args.seeds[0], args.seconds)
    st = driver.setup(run)
    rows = []
    try:
        for rate in args.rates:
            r = copy.deepcopy(run)
            r.cell["traffic"]["rate_per_s"] = rate
            ctx = driver.window(r, st)
            lat = ctx["latencies_ms"]
            due = traffic.open_loop(rate, args.seconds, run.seed)
            fifth = max(1, len(lat) // 5)
            first = sorted(lat[:fifth])[fifth // 2]
            last = sorted(lat[-fifth:])[fifth // 2]
            done = [d for d, x in zip(due, lat) if x != float("inf")]
            row = {"rate_per_s": rate, "requests": len(lat), "failed": ctx["failed"],
                   "p50_ms": stats.percentile(lat, 50), "p95_ms": stats.percentile(lat, 95),
                   "p99_ms": stats.percentile(lat, 99),
                   "completed_per_s": len(done) / ctx["window_s"],
                   "late_p99_ms": stats.percentile(ctx["late_ms"], 99),
                   "first_fifth_median_ms": first, "last_fifth_median_ms": last,
                   "occupancy": ctx["serve_clips"] / max(1, ctx["serve_batches"]),
                   "call_ms": 1e3 * ctx["predict_s"] / max(1, ctx["predict_calls"])}
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        driver.close(st)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("readings", "sweep"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--controls", nargs="*", default=[])
    ap.add_argument("--rates", type=float, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    harness.cache_dirs(ROOT)
    rows = (readings if args.what == "readings" else sweep)(harness, args)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

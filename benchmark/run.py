"""The benchmark of ``csts_torch``, the PyTorch/CUDA port, on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. One process runs one cell once: it builds the
port's model and its inputs from the seed on the card, warms up every shape
the cell uses (set-up, timed from the process's start), measures for
``--seconds``, checks what the timed path produced against the plain fp32
reference of ``benchmark/reference/``, and prints one JSON line as the last
line of its standard output: ``correct``, ``attempted``, ``failed``, the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics read from
a torch.profiler window inside the measured window (``--trace 1``),
``device``, with a trace ``breakdown``, and last ``checks``, each number
compared beside its limit (also the last lines of standard error). Without a
card, or with fewer than the cell asks for, it exits non-zero and prints no
result; so it does where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    harness.cache_dirs(ROOT)
    try:
        out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                               T_START)
    except harness.RunError as err:
        print(f"benchmark: {err}", file=sys.stderr)
        return err.code
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

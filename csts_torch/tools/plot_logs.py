"""Parse the ``json_stats`` records of a run's log into CSVs
(``tools/plot_logs.py``, without its figures: they need matplotlib, which the
card's machine lacks).

    python -m csts_torch.tools.plot_logs OUTPUT_DIR/stdout.log --out analysis/

The trainer and tester log one ``json_stats: {...}`` line per logged
iteration or epoch (``csts_torch/utils/logging.py``, the reference's
logging.py:87-96). This writes one ``<record_type>.csv`` per ``_type``
(train_iter, train_epoch, val_iter, val_epoch, test_iter, test_final), its
columns the union of that type's keys in record order, with a global step
column for iter records (from the "e/E" and "i/I" fraction fields), and
prints the last ``test_final`` record as JSON.
"""

import argparse
import csv
import json
import os
import re
import sys

_LINE = re.compile(r"json_stats: (\{.*\})\s*$")
_FRAC = re.compile(r"^(\d+)/(\d+)$")


def parse_records(path: str):
    """All json_stats records in the file, grouped by ``_type`` (file order)."""
    groups = {}
    with open(path, errors="replace") as f:
        for line in f:
            m = _LINE.search(line)
            if not m:
                continue
            try:
                rec = json.loads(m.group(1))
            except json.JSONDecodeError:
                continue
            groups.setdefault(rec.get("_type", "untyped"), []).append(rec)
    return groups


def add_global_step(records):
    """epoch "e/E" + iter "i/I" -> 0-based global step. If ANY record lacks the
    fraction fields, fall back to sequential numbering for ALL of them — mixing
    computed and positional steps would interleave small and large x values."""
    steps = []
    for rec in records:
        me = _FRAC.match(str(rec.get("epoch", "")))
        mi = _FRAC.match(str(rec.get("iter", "")))
        if not (me and mi):
            return list(range(len(records)))
        steps.append((int(me.group(1)) - 1) * int(mi.group(2)) + int(mi.group(1)) - 1)
    return steps


def write_csvs(groups, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for rtype, records in groups.items():
        cols = []
        for rec in records:
            cols.extend(k for k in rec if k not in cols)
        path = os.path.join(out_dir, f"{rtype}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            header = ["step"] + cols if rtype.endswith("_iter") else cols
            w.writerow(header)
            steps = add_global_step(records) if rtype.endswith("_iter") else None
            for i, rec in enumerate(records):
                row = [rec.get(c, "") for c in cols]
                w.writerow(([steps[i]] + row) if steps is not None else row)
        paths.append(path)
    return paths


def plot(groups, out_dir: str):
    """The figures' step of ``tools/plot_logs.py``: without matplotlib (never
    imported here) it says so, as the JAX tool does, and makes none."""
    print("matplotlib not available — CSVs only", file=sys.stderr)
    return []


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log", help="stdout.log (or any file with json_stats lines)")
    ap.add_argument("--out", default="log_analysis")
    args = ap.parse_args(argv)
    groups = parse_records(args.log)
    if not groups:
        print(f"no json_stats records found in {args.log}", file=sys.stderr)
        return 1
    for p in write_csvs(groups, args.out) + plot(groups, args.out):
        print(p)
    final = groups.get("test_final")
    if final:
        print("test_final:", json.dumps(final[-1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

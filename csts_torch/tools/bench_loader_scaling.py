"""The host feed's rate against its worker count (``tools/bench_loader_scaling.py``),
on the CPU only.

Sweeps DATA_LOADER.NUM_WORKERS over a synthetic test split in the reference's
npy layout (``csts_torch.data.synthetic.write_dataset``: 150-frame clips at
the given resolution) through the flagship config's test loader, and reports
clips/s a worker count. With ``--device-rate`` (the clips/s the card
consumes, from a measurement such as ``csts_torch/tools/bench_baseline.json``)
it also estimates the cores the feed needs to keep up.

    python -m csts_torch.tools.bench_loader_scaling [--clips 16] [--workers 0 1 2 4] \\
        [--batch 8] [--epochs 2] [--res 256 320] [--device-rate R] [--data-dir DIR]

Every loader is closed (``with construct_loader(...)``) before the next
point; a split it wrote into a temporary directory is removed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence


def sweep(cfg, workers: Sequence[int], epochs: int) -> list:
    """clips/s of the test loader at each worker count: one warm-up pass
    (the page cache and the workers' start), then ``epochs`` timed passes."""
    from csts_torch.data import loader as loader_lib

    curve = []
    for w in workers:
        cfg.DATA_LOADER.NUM_WORKERS = w
        with loader_lib.construct_loader(cfg, "test") as loader:
            for _ in loader:
                pass
            n = 0
            t0 = time.perf_counter()
            for _ in range(epochs):
                for batch in loader:
                    n += batch["video"].shape[0]
            dt = time.perf_counter() - t0
        curve.append({"workers": w, "clips_per_sec": n / dt})
        print(f"workers={w:3d}  {n / dt:8.2f} clips/s", flush=True)
    return curve


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clips", type=int, default=16)
    ap.add_argument("--workers", type=int, nargs="+", default=[0, 1, 2, 4])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=2, help="timed passes a point")
    ap.add_argument("--res", type=int, nargs=2, default=[256, 320], help="frames' H W")
    ap.add_argument("--device-rate", type=float, default=None,
                    help="clips/s the device consumes, for the sizing estimate")
    ap.add_argument("--data-dir", default=None)
    args = ap.parse_args(argv)

    from csts_torch.data.synthetic import write_dataset
    from csts_torch.presets import flagship_cfg

    root = args.data_dir or tempfile.mkdtemp(prefix="csts_loader_scaling_")
    try:
        prefix, splits = os.path.join(root, "clips.gaze"), os.path.join(root, "splits")
        if not os.path.exists(os.path.join(splits, "test_ego4d_gaze.csv")):
            print(f"writing {args.clips} synthetic {args.res[0]}x{args.res[1]} clips under "
                  f"{root}", flush=True)
            prefix, splits = write_dataset(root, "ego4d", num_clips=args.clips,
                                           res=tuple(args.res))
        cfg = flagship_cfg()
        cfg.DATA.PATH_PREFIX, cfg.DATA.PATH_TO_DATA_DIR = prefix, splits
        cfg.DATA.DECODING_BACKEND = "npy"
        cfg.TEST.BATCH_SIZE = args.batch
        cfg.TEST.NUM_ENSEMBLE_VIEWS = 1
        cfg.TEST.NUM_SPATIAL_CROPS = 1
        curve = sweep(cfg, args.workers, args.epochs)
    finally:
        if args.data_dir is None:
            shutil.rmtree(root, ignore_errors=True)
    best = max(curve, key=lambda p: p["clips_per_sec"])
    result = {"curve": curve, "host_cpus": os.cpu_count(), "best": best}
    if args.device_rate:
        per_core = best["clips_per_sec"] / os.cpu_count()
        result.update(clips_per_sec_per_core=per_core, device_clips_per_sec=args.device_rate,
                      cores_to_feed_device=args.device_rate / per_core)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":  # the loader's fork server imports this module
    main()

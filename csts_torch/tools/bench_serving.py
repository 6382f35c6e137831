"""Serving latency and throughput per batch bucket on one card, the
counterpart of the JAX package's ``tools/bench_serving.py``:

    python -m csts_torch.tools.bench_serving [--buckets 1 8 32 128] \\
        [--out chiprun_out/bench_serving.json]

For each bucket, a ``GazePredictor`` of that one bucket over the flagship
(bf16, seeded random weights) serves inputs made on the device from a seed,
through its bucket buffers and CUDA graph (``GazePredictor.serve``), after
the eager first request, the capture and a few replays:

* latency: each request fenced by a scalar read-back, what one online
  request waits for its heatmaps; p50 and p90 over the requests;
* throughput: requests issued back to back, one fence at the end (the
  JAX bench's protocol), as clips/s and ms a batch;
* the copy of one request's clips from host memory: straight from a
  pageable numpy array, and through a pinned staging buffer (host copy in,
  then an asynchronous copy), both fenced.

One JSON line per bucket, and the rows with the card's name and power
limit in ``--out`` (never the JAX package's TPU record ``SERVING_LAT.json``).
It runs on CUDA unless ``--device`` names another device; ``--device cpu
--small`` checks that it runs and measures nothing of a card.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

WARMUP = 3
LAT_ITERS = 20
THR_ITERS = 20


def _fence(probs: torch.Tensor) -> float:
    return float(probs[0, 0, 0, 0, 0])


def _percentile(ms: list, q: float) -> float:
    ms = sorted(ms)
    return ms[min(len(ms) - 1, int(len(ms) * q))]


def h2d_ms(video: np.ndarray, device: torch.device, iters: int) -> dict:
    """Median ms to copy ``video`` to the device: pageable, and through a
    pinned staging buffer; each copy fenced."""
    if device.type != "cuda":
        return {}
    dst = torch.empty(video.shape, dtype=torch.float32, device=device)
    stage = torch.empty(video.shape, dtype=torch.float32).pin_memory()

    def pageable():
        dst.copy_(torch.from_numpy(video))

    def pinned():
        stage.copy_(torch.from_numpy(video))
        dst.copy_(stage, non_blocking=True)

    out = {}
    for name, fn in (("pageable", pageable), ("pinned_staging", pinned)):
        times = []
        for _ in range(iters + 1):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"h2d_{name}_ms"] = _percentile(times[1:], 0.5)
    return out


def bench_bucket(cfg, state, b: int, device: torch.device, seed: int) -> dict:
    from csts_torch.serving import GazePredictor

    pred = GazePredictor(cfg, state, batch_sizes=(b,), device=device)
    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    gen = torch.Generator(device=device).manual_seed(seed)
    video = torch.randn((b, t, s, s, 3), generator=gen, device=device)
    audio = torch.randn((b, t, cfg.DATA.AUDIO_FREQ_BINS, cfg.DATA.AUDIO_WINDOW, 1),
                        generator=gen, device=device)
    t0 = time.perf_counter()
    _fence(pred.serve(video, audio))  # eager
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _fence(pred.serve(video, audio))  # the capture (on CUDA) and its first replay
    capture_s = time.perf_counter() - t0
    for _ in range(WARMUP):
        _fence(pred.serve(video, audio))

    lats = []
    for _ in range(LAT_ITERS):
        t0 = time.perf_counter()
        _fence(pred.serve(video, audio))
        lats.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    out = None
    for _ in range(THR_ITERS):
        out = pred.serve(video, audio)
    _fence(out)
    dt = time.perf_counter() - t0
    row = {
        "bucket": b, "latency_p50_ms": _percentile(lats, 0.5),
        "latency_p90_ms": _percentile(lats, 0.9),
        "pipelined_clips_per_sec": b * THR_ITERS / dt,
        "pipelined_ms_per_batch": 1e3 * dt / THR_ITERS,
        "first_request_s": first_s, "capture_request_s": capture_s,
        "graph": pred._slots[b].graph is not None,
    }
    row.update(h2d_ms(video.cpu().numpy(), device, LAT_ITERS))
    del pred
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row


def main(argv: Optional[Sequence[str]] = None) -> int:
    from csts_torch import resolve_device
    from csts_torch.models.csts import CSTS, build_spec, init_params
    from csts_torch.presets import flagship_cfg, small_cfg
    from csts_torch.tools import card_line, device_name

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--buckets", type=int, nargs="+", default=[1, 8, 32, 128])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true", help="the reduced model (small_cfg)")
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "bench_serving.json"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = small_cfg(1) if args.small else flagship_cfg()
    cfg.TRAIN.MIXED_PRECISION = True
    model = CSTS(build_spec(cfg))
    init_params(model, torch.Generator().manual_seed(args.seed))
    state = model.state_dict()
    del model
    rows = []
    for b in args.buckets:
        row = bench_bucket(cfg, state, b, device, args.seed)
        rows.append(row)
        print(json.dumps(row), flush=True)
    card = card_line() if device.type == "cuda" else "cpu (no device metric)"
    print(card, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "device": device_name(device), "small": args.small,
                   "rows": rows}, f, indent=1)
    print(f"# wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    main()

"""Benchmark: flagship CSTS-B 16x4 eval throughput on one CUDA card, the
port's counterpart of the JAX package's ``bench.py``.

    python -m csts_torch.tools.bench [--batch N]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "batch"},
the keys of ``bench.py``. It times the eval step (the bf16 forward and the
per-frame softmax at T=2, through the hand-written kernels) on (B, 8, 256,
256, 3) video and (B, 8, 256, 256, 1) audio made on the card from a seeded
generator: 3 warm-up calls, then 20 calls queued back to back between two
CUDA events and one synchronisation. Before timing, one forward at the
chosen batch is held against the same weights in fp32 through the kernels'
plain twins (``csts_torch.tools.heatmap_check``: the logits within 0.05 of
the reference's largest |logit|, per-frame softmax max|Δ| < 0.02, the bar of
``tests/test_golden_256.py``, at least one decided frame and the argmax
within one pixel on decided frames); a miss exits non-zero and prints no
result.

``vs_baseline`` compares with the first recorded run of the port
(``bench_baseline.json`` beside this file, with the card's name); the JAX
package's TPU baseline is never read. It raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

# The knee of the batch sweep on one H100 80GB HBM3 at 700 W (PERF.md §5):
# 1 -> 66.65, 2 -> 109.05, 4 -> 250.08, 8 -> 358.99, 16 -> 380.17,
# 32 -> 393.61, 64 -> 404.87, 96 -> 406.42, 128 -> 411.47 clips/s; 32 is the
# smallest batch within 5% of the best.
BATCH = 32
WARMUP = 3
ITERS = 20
CHECK_CHUNK = 8  # rows a reference forward takes at a time
BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_baseline.json")


def build(batch: int, device: torch.device, small: bool = False, seed: int = 0):
    """The fp32 model (reference weights from ``seed``), its bf16 copy at
    eval on ``device``, and one batch of bf16 inputs made on the device."""
    from csts_torch.models.csts import CSTS, build_spec, init_params
    from csts_torch.presets import flagship_cfg, small_cfg

    cfg = small_cfg(batch) if small else flagship_cfg()
    ref = CSTS(build_spec(cfg))
    init_params(ref, torch.Generator().manual_seed(seed))
    cfg.TRAIN.MIXED_PRECISION = True
    spec = build_spec(cfg)
    model = CSTS(spec)
    model.load_state_dict(ref.state_dict(), strict=True)
    model = model.to(torch.bfloat16).to(device).eval()
    gen = torch.Generator(device=device).manual_seed(seed)
    t, s = spec.num_frames, spec.crop_size
    video = torch.randn(batch, t, s, s, 3, generator=gen, device=device, dtype=torch.bfloat16)
    audio = torch.randn(batch, t, cfg.DATA.AUDIO_FREQ_BINS, cfg.DATA.AUDIO_WINDOW, 1,
                        generator=gen, device=device, dtype=torch.bfloat16)
    return cfg, spec, ref.eval(), model, video, audio


def check(ref_model, model, video, audio, device) -> dict:
    """One forward through the kernels against the fp32 plain twins."""
    from csts_torch.tools import heatmap_check, plain_twins

    with torch.inference_mode():
        logits = model(video, audio)
    ref_model = ref_model.to(device)
    with plain_twins(), torch.inference_mode():
        ref = torch.cat([ref_model(video[i : i + CHECK_CHUNK].float(),
                                   audio[i : i + CHECK_CHUNK].float())
                         for i in range(0, video.shape[0], CHECK_CHUNK)])
    ref_model.cpu()
    return heatmap_check(logits, ref)


def run(batch: int, device, small: bool = False, log=print) -> dict:
    """The check, then the timed run; returns clips/s and the check."""
    from csts_torch.train import step as step_lib

    device = torch.device(device)
    cfg, spec, ref_model, model, video, audio = build(batch, device, small)
    from csts_torch.tools import check_line

    res = check(ref_model, model, video, audio, device)
    log(f"# check at batch {batch}: {check_line(res)}")
    if not res["ok"]:
        return res
    eval_step = step_lib.make_eval_step(cfg, spec)
    batch_in = {"video": video, "audio": audio}
    for _ in range(WARMUP):
        eval_step(model, batch_in)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            eval_step(model, batch_in)
        end.record()
        torch.cuda.synchronize(device)
        seconds = start.elapsed_time(end) / 1e3
    else:  # a CPU run checks the path; its clock is no device metric
        t0 = time.perf_counter()
        for _ in range(ITERS):
            eval_step(model, batch_in)
        seconds = time.perf_counter() - t0
    res["clips_per_sec"] = batch * ITERS / seconds
    return res


def main(argv=None) -> int:
    from csts_torch import resolve_device
    from csts_torch.tools import card_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=BATCH, help="clips a call (default: the knee)")
    args = ap.parse_args(argv)
    device = resolve_device()
    res = run(args.batch, device)
    print(f"# {card_line()}")
    if not res["ok"]:
        print(f"# result check failed at batch {args.batch}: {res}")
        return 1
    cps = res["clips_per_sec"]
    baseline = None
    if os.path.exists(BASELINE_FILE):
        with open(BASELINE_FILE) as f:
            baseline = json.load(f).get("clips_per_sec")
    if baseline is None:
        with open(BASELINE_FILE, "w") as f:
            json.dump({"clips_per_sec": cps, "batch": args.batch,
                       "device": torch.cuda.get_device_name(device),
                       "note": "first recorded run of the port; later runs compare here"},
                      f, indent=1)
        baseline = cps
    print(json.dumps({
        "metric": "eval_clips_per_sec_per_chip",
        "value": round(cps, 2),
        "unit": "clips/s",
        "vs_baseline": round(cps / baseline, 3),
        "batch": args.batch,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Device time of the flagship's eval forward, or of one training step, by
kernel and by kernel family (``torch.profiler``), and the device's idle share.

Counterpart of the JAX package's ``tools/profile_forward.py``:

    python -m csts_torch.tools.profile_forward [--batch 8] [--train] [--out PATH]

The forward is ``GazePredictor.forward``'s program (the model at eval in
bf16, then the per-frame softmax) on random weights from a seed; ``--train``
profiles one step of ``make_train_step`` at ``flagship_train_cfg`` instead.
The result goes to ``--out`` as JSON. It runs on CUDA unless ``--device
cpu`` is given (with ``--small``, the reduced model: a check that the tool
runs, which reports no device time).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable

import torch

# device kernels by family, matched in order on the kernel name the profiler
# reports (the first family whose key is in the lowered name takes it)
FAMILIES = (
    ("K1 attention", ("attn_wg_kernel", "attn_merge_kernel", "attn_streamed_kernel")),
    ("B8 attention_bwd", ("dq_wg_kernel", "dkdv_wg_kernel", "dq_streamed_kernel",
                          "dkdv_streamed_kernel", "namespace)::reduce_kernel<")),
    # B7 is the TRAIN = true instance of K2's templates (LN2 and two GEMMs)
    ("B7 mlp_tail_train", ("tail_ln_kernel<true", "tail_fc1_kernel<true",
                           "tail_fc2_kernel<true", "mlp_tail_f32_kernel<true")),
    ("K2 mlp_tail", ("tail_ln_kernel", "tail_fc1_kernel", "tail_fc2_kernel",
                     "mlp_tail_f32_kernel")),
    ("K3 t2_upsample", ("t2_upsample_kernel",)),
    ("B9a hw2_upsample", ("hw2_upsample_kernel",)),
    # B4's kernels (the Q conv, the attention, the proj GEMM and K2's split
    # tail), B5's three and B3's; their fp32 bodies and first designs stay
    # with the whole blocks'
    ("B4 pool_block", ("pool_conv_kernel", "pool_attn_kernel", "pool_proj_kernel",
                       "pool_ln_kernel", "pool_fc1_kernel", "pool_fc2_kernel")),
    ("B5 decoder_block", ("decoder_conv_kernel", "decoder_attn_kernel", "decoder_tail_kernel")),
    # B3's (the Q GEMM, the attention, the proj GEMM, LN2 where the proj does
    # not hold whole rows, and K2's split tail; at 3-8 heads also B9b/B9c's)
    ("B3 block", ("block_ln_kernel", "block_q_kernel", "block_attn_kernel", "block_proj_kernel",
                  "block_fc1_kernel", "block_fc2_kernel")),
    ("B3-B5, B9b/c whole blocks", ("block_mma_kernel", "block_f32_kernel")),
    ("convolution", ("conv", "cudnn", "implicit", "dgrad", "fprop", "winograd")),
    ("matmul", ("gemm", "cutlass", "xmma", "matmul", "nvjet")),
    ("reduction", ("reduce",)),
    ("copy/layout", ("copy", "cat", "transpose", "permute", "index", "upsample")),
)


def family(name: str) -> str:
    low = name.lower()
    return next((f for f, keys in FAMILIES if any(k in low for k in keys)), "elementwise/other")


def device_trace(fn: Callable[[], object]) -> tuple:
    """One call of ``fn`` (after one untraced call) under torch.profiler.
    Returns (wall ms of the traced call, device busy ms as the union of the
    device activities' intervals, {kernel name: summed ms}, activity count);
    the device terms are 0 without a card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn()
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # one entry per device activity (the event list may repeat one)
    spans = {(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)}
    by_name: dict = {}
    for name, start, end in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    busy, reach = 0.0, float("-inf")
    for _, start, end in sorted(spans, key=lambda s: s[1]):
        busy += max(0.0, end - max(start, reach)) / 1e3
        reach = max(reach, end)
    return wall_ms, busy, by_name, len(spans)


def device_ms(fn: Callable[[], object], calls: int = 20) -> float:
    """Device time per call of ``fn``: the summed durations of the device
    activities (kernels, copies) that ``calls`` calls launch, over ``calls``.
    It does not depend on how fast the host launches. 0 without a card.
    The profiler now and then reports no device activity, or only part of
    it, for a window that had more: two windows that saw activity are
    traced (up to four tries) and the larger reading is kept."""
    readings = []
    for _ in range(4 if torch.cuda.is_available() else 1):
        _, _, by_name, _ = device_trace(lambda: [fn() for _ in range(calls)])
        if by_name:
            readings.append(sum(by_name.values()) / calls)
            if len(readings) == 2:
                break
    return max(readings, default=0.0)


def profile_forward(fn: Callable[[], object], fwd_ms: float, log: Callable[[str], None] = print,
                    top: int = 16) -> dict:
    """Device time of one call of ``fn`` by kernel family (torch.profiler),
    and the device's idle share: of the profiled window, whose wall carries
    the profiler's own overhead, and of ``fwd_ms``, the unprofiled call's
    time from back-to-back calls, where the host runs ahead of the device."""
    wall_ms, busy, by_name, n = device_trace(fn)
    fam: dict = {}
    for name, ms in by_name.items():
        fam[family(name)] = fam.get(family(name), 0.0) + ms
    out = {"wall_ms": wall_ms, "device_busy_ms": busy, "device_kernels": n,
           "device_idle_share": (1 - busy / wall_ms) if busy else None,
           "device_idle_share_unprofiled": (1 - busy / fwd_ms) if busy else None,
           "families_ms": dict(sorted(fam.items(), key=lambda kv: -kv[1])),
           "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])}
    if not busy:
        log("  profiler: no device time reported")
    else:
        log(f"  profile: wall {wall_ms:.2f} ms, {n} device activities busy "
            f"{busy:.2f} ms, idle share {out['device_idle_share']:.3f} (of the unprofiled "
            f"{fwd_ms:.2f} ms call {out['device_idle_share_unprofiled']:.3f}); " + ", ".join(
                f"{k} {v:.2f}" for k, v in out["families_ms"].items()))
        for name, ms in out["top_kernels_ms"].items():
            log(f"    {ms:8.3f} ms  {name[:110]}")
    return out


def main(argv=None) -> int:
    from csts_torch import resolve_device
    from csts_torch.models.csts import CSTS, build_spec, init_params
    from csts_torch.presets import flagship_cfg, flagship_train_cfg, small_cfg
    from csts_torch.tools import card_line, device_name, mean_ms
    from csts_torch.train import step as train_lib
    from csts_torch.train.losses import frame_softmax

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5, help="calls timed before the profile")
    ap.add_argument("--train", action="store_true", help="one training step, not the forward")
    ap.add_argument("--small", action="store_true", help="the reduced model (small_cfg)")
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "profile_forward.json"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)

    if args.train:
        cfg = small_cfg(args.batch) if args.small else flagship_train_cfg()
        cfg.TRAIN.MIXED_PRECISION = True
        cfg.TRAIN.BATCH_SIZE = args.batch
    else:
        cfg = small_cfg(args.batch) if args.small else flagship_cfg()
        cfg.TRAIN.MIXED_PRECISION = True
    spec = build_spec(cfg)
    b, t = args.batch, spec.num_frames
    video = torch.randn(b, t, spec.crop_size, spec.crop_size, 3, generator=gen, device=device)
    audio = torch.randn(b, t, cfg.DATA.AUDIO_FREQ_BINS, cfg.DATA.AUDIO_WINDOW, 1,
                        generator=gen, device=device)
    if args.train:
        state = train_lib.create_train_state(cfg, spec, torch.Generator().manual_seed(0),
                                             device=str(device))
        hw = spec.crop_size // 4
        hm = torch.rand(b, t, hw, hw, generator=gen, device=device)
        batch = {"video": video, "audio": audio, "labels_hm": hm / hm.sum((2, 3), keepdim=True)}
        step = train_lib.make_train_step(cfg, spec, steps_per_epoch=1000)
        drop_gen = torch.Generator().manual_seed(1)
        fn = lambda: step(state, batch, drop_gen)  # noqa: E731
        what = f"train step, batch {b}"
    else:
        model = CSTS(spec)
        init_params(model, torch.Generator().manual_seed(0))
        model = model.to(torch.bfloat16).to(device).eval()

        def fn():
            with torch.inference_mode():
                return frame_softmax(model(video, audio), temperature=2.0)
        what = f"eval forward, batch {b}, bf16"
    name = device_name(device)
    ms = mean_ms(fn, device, args.iters)
    clock = "CUDA events" if device.type == "cuda" else "host clock, no device metric"
    print(f"{'small_cfg' if args.small else 'flagship'} {what} on {name}: {ms:.3f} ms ({clock})")
    out = profile_forward(fn, ms)
    out.update(what=what, small=args.small, device=name, ms=ms)
    if device.type == "cuda":
        out["card"] = card_line()
        print(out["card"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

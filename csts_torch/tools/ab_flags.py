"""One-process A/B of the port's experiment switches on the full flagship
eval forward.

Counterpart of the JAX package's ``tools/ab_flags.py``:

    python -m csts_torch.tools.ab_flags [--batch 8] [--iters 20] \
        [--configs base head_commute+t2_skip head_commute+t2_skip+hw2_skip]

Each config is ``base`` or '+'-joined switch names from the registry below
(the JAX package's switches the port has, with their names and defaults).
``base`` forces every registry switch off; every config sets every switch
(on if named, else off) and restores them all afterwards, so ``base`` stays
all-off whatever the module defaults become.

Each config runs the flagship's eval forward (the model in bf16 on random
weights from a seed, then the per-frame softmax at T=2) at ``--batch``; the
configs are timed in turns, ``--rounds`` times, with CUDA events, and each
prints ms and clips/s (the median over rounds) and its ratio to base. The
numerical guard is JAX's, on the per-frame softmax against base: its max|Δ|
is printed, and the tool fails if it reaches 0.02 (the bf16 bar of
``tests/test_golden_256.py``). It runs on CUDA unless ``--device cpu`` is
given; ``--small`` takes the reduced model (a check on the CPU, where the
kernels' plain twins run and the host clock gives no device metric).

Switches (the defaults are JAX's: head_commute and t2_skip on, the others off):
  head_commute  classify the stem skip before its T-resize (``models/csts.py``
                ``HEAD_COMMUTE``)
  t2_skip       the x2 T resizes (d4's skip, the head's stem map) through K3
                (``kernels/upsample.py`` ``T2_SKIP_KERNEL``); off, plain
  hw2_skip      the decoder's stride-(1,2,2) skips on B5's route through B9a
                (``kernels/upsample.py`` ``HW2_SKIP_KERNEL``)
  split_resize  JAX's choice between two XLA lowerings of the trilinear
                resize (``ops/resize.py`` ``SPLIT_AXES_T_FIRST``); it has no
                meaning here and nothing reads it: flipping it changes nothing
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import statistics
from typing import Dict, Sequence, Tuple

import torch

GUARD = 0.02


# each switch's module and attribute, by name (imported where flipped)
SWITCHES = {
    "head_commute": ("csts_torch.models.csts", "HEAD_COMMUTE"),
    "split_resize": ("csts_torch.ops.resize", "SPLIT_AXES_T_FIRST"),
    "t2_skip": ("csts_torch.kernels.upsample", "T2_SKIP_KERNEL"),
    "hw2_skip": ("csts_torch.kernels.upsample", "HW2_SKIP_KERNEL"),
}


def flag_registry() -> Dict[str, Tuple[object, str]]:
    return {name: (importlib.import_module(mod), attr) for name, (mod, attr) in SWITCHES.items()}


@contextlib.contextmanager
def flags(conf: str):
    """Every registry switch on if ``conf`` names it, else off; all restored
    on exit."""
    registry = flag_registry()
    names = [] if conf == "base" else conf.split("+")
    unknown = set(names) - set(registry)
    if unknown:
        raise ValueError(f"unknown switches {sorted(unknown)}; the registry has {sorted(registry)}")
    saved = {key: getattr(mod, attr) for key, (mod, attr) in registry.items()}
    try:
        for key, (mod, attr) in registry.items():
            setattr(mod, attr, key in names)
        yield
    finally:
        for key, (mod, attr) in registry.items():
            setattr(mod, attr, saved[key])


def build(batch: int, device, small: bool = False, seed: int = 0):
    """The flagship (or ``small_cfg``) in bf16 at eval on ``device``, and one
    batch of random inputs; returns (model, video, audio)."""
    from csts_torch.models.csts import CSTS, build_spec, init_params
    from csts_torch.presets import flagship_cfg, small_cfg

    cfg = small_cfg(batch) if small else flagship_cfg()
    cfg.TRAIN.MIXED_PRECISION = True
    spec = build_spec(cfg)
    model = CSTS(spec)
    init_params(model, torch.Generator().manual_seed(seed))
    model = model.to(torch.bfloat16).to(device).eval()
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    t, s = spec.num_frames, spec.crop_size
    video = torch.randn(batch, t, s, s, 3, generator=gen, device=device)
    audio = torch.randn(batch, t, cfg.DATA.AUDIO_FREQ_BINS, cfg.DATA.AUDIO_WINDOW, 1,
                        generator=gen, device=device)
    return model, video, audio


def forward(model, video, audio) -> torch.Tensor:
    """The served forward: logits, then the per-frame softmax (fp32)."""
    from csts_torch.train.losses import frame_softmax

    with torch.inference_mode():
        return frame_softmax(model(video, audio).float(), temperature=2.0)


def run(configs: Sequence[str], batch: int, iters: int, rounds: int, device,
        small: bool = False, log=print) -> Dict[str, dict]:
    """Per config: ms per forward in each round (configs in turns), the
    median, clips/s, and the per-frame softmax max|Δ| against base."""
    from csts_torch.tools import device_name, mean_ms

    device = torch.device(device)
    model, video, audio = build(batch, device, small)
    out: Dict[str, dict] = {}
    ref = None
    for conf in configs:
        with flags(conf):
            probs = forward(model, video, audio)
        if conf == "base":
            ref = probs
        out[conf] = {"rounds_ms": [], "device": device_name(device), "batch": batch}
        out[conf]["softmax_max_abs_diff_vs_base"] = (
            float((probs - ref).abs().max()) if ref is not None and conf != "base" else None)
    for _ in range(rounds):
        for conf in configs:
            with flags(conf):
                out[conf]["rounds_ms"].append(
                    mean_ms(lambda: forward(model, video, audio), device, iters))
    for conf, res in out.items():
        res["ms"] = statistics.median(res["rounds_ms"])
        res["clips_per_s"] = batch * 1e3 / res["ms"]
        log(f"{conf:24s} {res['ms']:9.3f} ms/forward {res['clips_per_s']:9.2f} clips/s  (rounds "
            + ", ".join(f"{x:.3f}" for x in res["rounds_ms"]) + ")")
    if "base" in out:
        for conf, res in out.items():
            res["ratio_vs_base"] = out["base"]["ms"] / res["ms"]
            if conf != "base":
                log(f"# {conf}: {res['ratio_vs_base']:.3f}x vs base, per-frame softmax max|Δ| "
                    f"vs base {res['softmax_max_abs_diff_vs_base']:.3g}")
    return out


def main(argv=None) -> int:
    from csts_torch import resolve_device
    from csts_torch.tools import card_line, device_name

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3, help="turns over the configs")
    ap.add_argument("--configs", nargs="+",
                    default=["base", "head_commute+t2_skip", "head_commute+t2_skip+hw2_skip"],
                    help="each entry: 'base' or '+'-joined switch names from the registry")
    ap.add_argument("--small", action="store_true", help="the reduced model (small_cfg)")
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    clock = "CUDA events" if device.type == "cuda" else "host clock, no device metric"
    print(f"device: {device_name(device)}  batch={args.batch} iters={args.iters} "
          f"rounds={args.rounds} ({clock})")
    res = run(args.configs, args.batch, args.iters, args.rounds, device, args.small)
    if device.type == "cuda":
        print(card_line())
    bad = {c: r["softmax_max_abs_diff_vs_base"] for c, r in res.items()
           if (r["softmax_max_abs_diff_vs_base"] or 0.0) >= GUARD}
    if bad:
        print(f"guard: per-frame softmax differs from base by {GUARD} or more: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

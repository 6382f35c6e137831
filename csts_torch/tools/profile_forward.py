"""Device time of the flagship's eval forward, or of one training step, by
kernel and by kernel family (``torch.profiler``), and the device's idle share.

Counterpart of the JAX package's ``tools/profile_forward.py``:

    python -m csts_torch.tools.profile_forward [--batch 8] [--train] [--out PATH]
        [--windows N] [--export-windows N]

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
from typing import Callable, Iterable

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


# torch.profiler keeps no device activity that starts before its trace
# window, and the window opens a little after ``profile``'s entry returns: a
# call made at once loses a prefix of its kernels now and then (``--windows``
# counts how often). So the call waits this long inside the window, after a
# sync, and the window stays open as long after it.
WINDOW_MARGIN_S = 0.02
# Once the process has run a ``torch.export`` (serving's ``export_compiled``),
# every window loses the device activity of its first few launches, however
# long the margin: 2 after one export on an H100 (``--export-windows``),
# dozens late in a long run. So each window first makes this many launches of a spin kernel
# (``torch.cuda._sleep``) and syncs, and only then the call; the spin
# kernels' activities are left out of what the window reports.
PRIMING_LAUNCHES = 256
_PRIMING_KERNEL = "spin_kernel"
# every traced window's record (``_window_record``), oldest first, for a
# run's log; cleared by whoever reads it
WINDOWS: list = []
# host calls that put work on the device: CUDA runtime and driver launches,
# copies and fills (each has a device activity of its correlation id)
_LAUNCHES = ("launch", "memcpy", "memset")


def _is_launch(e) -> bool:
    name = e.name().lower()
    return (e.device_type() == torch.autograd.DeviceType.CPU and name.startswith("cu")
            and any(w in name for w in _LAUNCHES))


def _is_activity(e) -> bool:
    return (e.device_type() != torch.autograd.DeviceType.CPU
            and not getattr(e, "is_user_annotation", lambda: False)())


def _window_record(prof, call_ns: int, margin_s: float, priming: int = 0) -> dict:
    """What a traced window shows of its call: the host's launches (CUDA
    runtime and driver calls that put work on the device) after the
    ``priming`` ones that open the window, the device activities of those,
    the call's launches with no activity of their correlation id ("lost"),
    the priming launches lost ("priming_lost"), the window's start in µs
    from the call's on the host's clock, and the least gap from a launch to
    its activity's start (a few µs on an idle card; less than 0 only where
    the device's clock and the host's disagree). A profiler without these
    fields gives ``recorded`` False and the reason."""
    record = {"margin_ms": margin_s * 1e3, "recorded": False, "at_s": time.monotonic()}
    try:
        events = prof.profiler.kineto_results.events()
        trace_ns = prof.profiler.kineto_results.trace_start_ns()
        launches, device = [], {}
        for e in events:
            if _is_launch(e):
                launches.append((e.start_ns(), e.correlation_id()))
            elif _is_activity(e):
                device.setdefault(e.correlation_id(), []).append(e.start_ns())
    except (AttributeError, TypeError) as err:
        return {**record, "why": repr(err)}
    launches.sort()
    primed_lost = sum(c not in device for _, c in launches[:priming])
    launches = {c: t for t, c in launches[priming:]}
    device = {c: v for c, v in device.items() if c in launches}
    gaps = [min(device[c]) - t for c, t in launches.items() if c in device]
    return {**record, "recorded": True,
            "launches": len(launches), "activities": sum(len(v) for v in device.values()),
            "lost": sum(c not in device for c in launches), "priming_lost": primed_lost,
            "window_us": (trace_ns - call_ns) / 1e3,
            "least_gap_us": min(gaps) / 1e3 if gaps else None}


def _device_spans(fn: Callable[[], object], warm: bool = True,
                  margin_s: float = WINDOW_MARGIN_S, priming: int = PRIMING_LAUNCHES) -> tuple:
    """(wall ms, {(name, start, end)}, record): one call of ``fn`` under
    torch.profiler (after one untraced call unless ``warm`` is off), made
    ``margin_s`` into the window after ``priming`` spin kernels, its device
    activities, one entry each (the event list may repeat one; the priming
    launches' left out), and the window's ``_window_record`` (also appended
    to ``WINDOWS``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    margin = margin_s if cuda else 0.0
    priming = priming if cuda else 0
    if warm:
        fn()
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(priming):
            torch.cuda._sleep(1)
        sync()
        time.sleep(margin)
        call_ns = time.time_ns()
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(margin)
    spans = {(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)
             and _PRIMING_KERNEL not in e.name}
    record = (_window_record(prof, call_ns, margin, priming) if cuda
              else {"recorded": False})
    if cuda:
        WINDOWS.append(record)
    return wall_ms, spans, record


def kernel_sequence(fn: Callable[[], object], margin_s: float = WINDOW_MARGIN_S) -> tuple:
    """The device activities' names of one call of ``fn`` (no untraced call
    first), made ``margin_s`` into its window, in the order they started."""
    spans = _device_spans(fn, warm=False, margin_s=margin_s)[1]
    return tuple(name for name, _, _ in sorted(spans, key=lambda s: s[1]))


def window_losses(seqs: list) -> dict:
    """Of one call's kernel sequences from several windows: how many differ
    from the most common one, and for each that does, how many of that
    sequence's first kernels it lacks where it lacks only a prefix (else -1)."""
    ref = max(set(seqs), key=seqs.count)
    lost = [len(ref) - len(s) if len(s) < len(ref) and s == ref[len(ref) - len(s):] else -1
            for s in seqs if s != ref]
    return {"windows": len(seqs), "kernels": len(ref), "differ": len(lost), "prefix_lost": lost}


def kernel_counts(fn: Callable[[], object]) -> dict:
    """{device activity name: how many times one call of ``fn`` ran it}
    (torch.profiler; no untraced call first). A CUDA graph's replay runs no
    Python, so this is how its kernels are counted. Empty without a card."""
    counts: dict = {}
    for name, _, _ in _device_spans(fn, warm=False)[1]:
        counts[name] = counts.get(name, 0) + 1
    return counts


def _trace(fn: Callable[[], object], warm: bool = True,
           margin_s: float = WINDOW_MARGIN_S) -> tuple:
    """``device_trace``'s terms, then the window's record."""
    wall_ms, spans, record = _device_spans(fn, warm, margin_s)
    by_name: dict = {}
    for name, start, end in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    busy, reach = 0.0, float("-inf")
    for _, start, end in sorted(spans, key=lambda s: s[1]):
        busy += max(0.0, end - max(start, reach)) / 1e3
        reach = max(reach, end)
    counts: dict = {}
    for name, _, _ in spans:
        counts[name] = counts.get(name, 0) + 1
    return wall_ms, busy, by_name, len(spans), counts, record


def device_trace(fn: Callable[[], object]) -> tuple:
    """One call of ``fn`` (after one untraced call) under torch.profiler.
    Returns (wall ms of the traced call, device busy ms as the union of the
    device activities' intervals, {kernel name: summed ms}, activity count);
    the device terms are 0 without a card."""
    return _trace(fn)[:4]


def whole_window(reading: float, counts: dict, calls: int, lost: int = 0) -> bool:
    """Whether a window of ``calls`` calls of one function shows all its
    work: some device time, no launch of the calls ``lost`` (without an
    activity), and each activity a multiple of ``calls`` times (every call
    launches the same work, so a window that lost part of it fails this)."""
    return reading > 0 and not lost and all(n % calls == 0 for n in counts.values())


def agreed_reading(windows: Iterable, calls: int) -> tuple:
    """Of (ms per call, {activity name: count}, launches lost) windows of
    ``calls`` calls, taken in turn: (the larger reading of the first two
    whole windows that agree on the counts, {activity name: times one call
    runs it}), or (None, None) where none do."""
    seen = []
    for reading, counts, lost in windows:
        if not whole_window(reading, counts, calls, lost):
            continue
        match = [ms for ms, c in seen if c == counts]
        if match:
            return max(reading, *match), {name: n // calls for name, n in counts.items()}
        seen.append((reading, counts))
    return None, None


def device_reading(fn: Callable[[], object], calls: int = 20, tries: int = 6) -> tuple:
    """(device ms per call of ``fn``, {device activity name: times one call
    runs it}): the summed durations of the device activities (kernels,
    copies) that ``calls`` calls launch, over ``calls``. It does not depend
    on how fast the host launches. (0.0, {}) without a card.
    A window can still lose part of its activity, so the reading is
    ``agreed_reading``'s over up to ``tries`` windows: (None, None) where no
    two whole windows agree."""
    if not torch.cuda.is_available():
        return 0.0, {}

    def windows():
        for _ in range(tries):
            _, _, by_name, _, counts, record = _trace(lambda: [fn() for _ in range(calls)])
            yield sum(by_name.values()) / calls, counts, record.get("lost", 0)

    return agreed_reading(windows(), calls)


def device_ms(fn: Callable[[], object], calls: int = 20) -> "float | None":
    """``device_reading``'s device ms per call of ``fn`` (None where the
    profiler gave no two whole windows that agree)."""
    return device_reading(fn, calls)[0]


# the port's own kernels' families (the rest are PyTorch's and the libraries')
PORT_FAMILIES = tuple(f for f, _ in FAMILIES
                      if f not in ("convolution", "matmul", "reduction", "copy/layout"))


def profile_forward(fn: Callable[[], object], fwd_ms: float, log: Callable[[str], None] = print,
                    top: int = 16, expect: "dict | None" = None, tries: int = 4) -> dict:
    """Device time of one call of ``fn`` by kernel family (torch.profiler),
    and the device's idle share: of the profiled window, whose wall carries
    the profiler's own overhead, and of ``fwd_ms``, the unprofiled call's
    time from back-to-back calls, where the host runs ahead of the device.
    On a card the window must be whole: device time, no launch of the call
    without its activity, and with ``expect`` ({device activity name: times
    one call runs it} for the port's kernels, as ``device_reading`` counts
    them from the launches) just those activities of the port's kernel
    families; one that is not is traced again, up to ``tries`` windows.
    ``whole`` says which the last was (None without a card), ``traces`` how
    many were taken."""
    cuda = torch.cuda.is_available()
    for n_trace in range(1, tries + 1):
        wall_ms, busy, by_name, n, counts, record = _trace(fn)
        ours = {k: c for k, c in counts.items() if family(k) in PORT_FAMILIES}
        whole = (busy > 0 and not record.get("lost") and (expect is None or ours == expect)
                 if cuda else None)
        if whole is not False:
            break
        log(f"  profile: window {n_trace} not whole (launches lost {record.get('lost')}"
            + (f"; the port's kernels {sum(ours.values())} activities, launched "
               f"{sum(expect.values())}" if expect is not None else "") + ")")
    fam: dict = {}
    for name, ms in by_name.items():
        fam[family(name)] = fam.get(family(name), 0.0) + ms
    out = {"wall_ms": wall_ms, "device_busy_ms": busy, "device_kernels": n,
           "whole": whole, "traces": n_trace, "lost": record.get("lost"),
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


def export_windows(cfg, device, windows: int) -> list:
    """Per profiler window of 20 matmuls: its launches, the ones whose
    device activity it lost, and the priming ones lost, in ``windows``
    windows with no priming launches and as many with PRIMING_LAUNCHES,
    before and after serving's ``export_compiled`` and ``from_exported`` of
    the model at ``cfg`` (batch 1) in this process: the finding behind
    PRIMING_LAUNCHES. Without a card the rows hold no counts."""
    import tempfile

    from csts_torch.models.csts import CSTS, build_spec, init_params
    from csts_torch.serving import GazePredictor

    model = CSTS(build_spec(cfg))
    init_params(model, torch.Generator().manual_seed(0))
    pred = GazePredictor(cfg, model.state_dict(), batch_sizes=(1,), device=device)
    del model
    x = torch.randn(1024, 1024, device=device)
    rows = []

    def trace(when: str) -> None:
        for priming in (0, PRIMING_LAUNCHES):
            for _ in range(windows):
                rec = _device_spans(lambda: [x @ x for _ in range(20)], priming=priming)[2]
                rows.append({"when": when, "priming": priming, **{
                    k: rec.get(k) for k in ("launches", "activities", "lost", "priming_lost")}})

    trace("before export")
    with tempfile.TemporaryDirectory() as art:
        pred.export_compiled(art)
        GazePredictor.from_exported(art, device=device)
    trace("after export")
    return rows


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
    ap.add_argument("--windows", type=int, default=0,
                    help="also trace the call alone in this many windows with no margin and "
                         "as many with WINDOW_MARGIN_S, in turns, and count the windows whose "
                         "kernels differ")
    ap.add_argument("--export-windows", type=int, default=0,
                    help="also count, in this many windows of 20 matmuls with no priming "
                         "launches and as many with PRIMING_LAUNCHES, before and after "
                         "serving's export_compiled, the launches whose activity a window lost")
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
    if args.windows:
        turns = {0.0: [], WINDOW_MARGIN_S: []}
        for _ in range(args.windows):
            for margin, seqs in turns.items():
                seqs.append(kernel_sequence(fn, margin))
        out["windows"] = [{"margin_ms": margin * 1e3, **window_losses(seqs)}
                          for margin, seqs in turns.items()]
        for row in out["windows"]:
            print(f"windows, the call {row['margin_ms']:g} ms into each: {row['differ']} of "
                  f"{row['windows']} differ from the {row['kernels']}-kernel sequence; "
                  f"first kernels lost {row['prefix_lost']} (-1: not a prefix)")
    if args.export_windows:
        out["export_windows"] = export_windows(cfg, device, args.export_windows)
        for row in out["export_windows"]:
            print(f"export windows, {row['when']}, {row['priming']} priming launches: "
                  f"launches {row['launches']}, activities {row['activities']}, lost "
                  f"{row['lost']}, priming launches lost {row['priming_lost']}")
    if device.type == "cuda":
        out["card"] = card_line()
        print(out["card"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

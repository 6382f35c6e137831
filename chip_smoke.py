#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``csts_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card (``nvidia-smi`` name and power limit) and the kernel build from
     ``csts_torch/csrc`` (seconds, registers per kernel);
  2. the flagship CSTS-B 16x4 (256², 16+4 blocks, bf16) with seeded random
     weights behind a ``GazePredictor(batch_sizes=(1, 8))``; one warm-up
     request per bucket records the inputs of every kernel launch;
  3. each kernel (K1 attention, K2 MLP tail, K3 T×2 upsample, and the
     whole-block kernels B3 block, B4 pool_block, B5 decoder_block) against
     its plain PyTorch version at every distinct shape the forward launched
     it with, in bf16 and in fp32 (TF32 off), with the kernel's, the plain
     version's and one library call's time at the batch-8 shapes, and for
     the whole-block kernels the same block through the K1+K2 route;
  4. the serving path: three requests (1, 5 and 8 clips) once to warm up,
     then launch counters set to 0, the same requests timed, counters read
     (each must equal its launches per forward times 3); outputs checked
     (shapes, finite, each frame's heatmap sums to 1) and held against the
     same weights through the plain versions in fp32 on the card; the
     batch-8 forward timed and profiled (device time by kernel family).
It prints the ``kernels`` JSON line, the card line and, last, the result line.
Per-shape details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from csts_torch.kernels import _build  # noqa: E402
from csts_torch.kernels import attention as ka  # noqa: E402
from csts_torch.kernels import block as kb  # noqa: E402
from csts_torch.kernels import upsample as kup  # noqa: E402
from csts_torch.models import mvit as tmvit  # noqa: E402
from csts_torch.models.csts import CSTS, build_spec, init_params  # noqa: E402
from csts_torch.presets import flagship_cfg  # noqa: E402
from csts_torch.serving import GazePredictor  # noqa: E402
from csts_torch.train.losses import frame_softmax  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and bf16 tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

SEED = 0
REQUESTS = (1, 5, 8)
# launches per forward on the flagship: B3 takes v0, a0 and v2, B4 v1, v3, a1
# and a2, B5 d2-d4; the 16 other blocks (the two fusion blocks among them) run
# K1 and K2; K3 serves d4's skip and the head's stem skip
PER_FORWARD = {"attention": 16, "mlp_tail": 16, "t2_upsample": 2,
               "block": 3, "pool_block": 4, "decoder_block": 3}

# Tolerances of kernel vs plain version on the same inputs.
#  fp32: the CPU bars of tests/test_torch_kernels.py (K1 2e-5, K2 3e-5 + 1e-4
#        relative, K3 1e-6); both sides are exact fp32 up to summation order.
#  bf16: K1 3e-2·max(1, max|ref|): the bar of tests/test_pallas_attention.py:121,
#        whose outputs stay below 1, scaled to the output's magnitude, since a
#        bf16 ulp grows with it (the flagship's v14/v15 outputs reach 4-8, where
#        one ulp is 0.03125); the probabilities are rounded to bf16 at other
#        points (unnormalised per key chunk in the kernel, normalised in the
#        plain version), and the output once on each side. K2 two bf16 ulps of the
#        largest output, 2**-6·max(1, max|ref|): both round LN2(x), the hidden
#        and the output at the same points and differ only in fp32 summation
#        order, which can flip one rounding. K3 one bf16 ulp, 2**-7·max(1,
#        max|ref|): the same two-tap fp32 formula, the kernel's fused
#        multiply-add may differ in the last fp32 bit and flip one rounding.
#  B3, B4, B5 (whole blocks): fp32 the CPU bars of tests/test_torch_blocks.py
#        (B3 3e-5, B4 and B5 5e-5, each + 1e-4 relative). bf16 four ulps of the
#        largest output, 2**-5·max(1, max|ref|): both sides round LN1, q, the
#        probabilities, av, LN2 and the hidden at the same points, but the
#        kernel rounds the probabilities unnormalised (as K1, whose bar is
#        3e-2) and sums in another order, so a rounding of q or av may flip;
#        res1 is fp32 on both sides and adds no rounding of its own.
FP32_ATOL = {"attention": 2e-5, "mlp_tail": 3e-5, "t2_upsample": 1e-6,
             "block": 3e-5, "pool_block": 5e-5, "decoder_block": 5e-5}
FP32_RTOL = {"attention": 0.0, "mlp_tail": 1e-4, "t2_upsample": 0.0,
             "block": 1e-4, "pool_block": 1e-4, "decoder_block": 1e-4}


def bf16_bar(name: str, ref: torch.Tensor) -> float:
    scale = max(1.0, float(ref.float().abs().max()))
    return {"attention": 3e-2 * scale, "mlp_tail": 2.0 ** -6 * scale,
            "t2_upsample": 2.0 ** -7 * scale, "block": 2.0 ** -5 * scale,
            "pool_block": 2.0 ** -5 * scale, "decoder_block": 2.0 ** -5 * scale}[name]


def _attn_library(q, k, v, scale, mask=None):
    m = None if mask is None else mask.to(q.dtype)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=m, scale=scale)


def _t2_library(x, thw):
    b, l, c = x.shape
    grid = x.reshape(b, *thw, c).permute(0, 4, 1, 2, 3)
    return F.interpolate(grid, scale_factor=(2, 1, 1), mode="trilinear", align_corners=False)


def _attn_cost(q, k, v, scale, mask=None):
    b, n, lq, hd = q.shape
    lk = k.shape[2]
    item = q.element_size()
    nbytes = item * (2 * b * n * lq * hd + 2 * b * n * lk * hd)
    if mask is not None:
        nbytes += 4 * lq * lk
    return nbytes, 4 * b * n * lq * lk * hd


def _tail_cost(x, ln_w, ln_b, w1, b1, w2, b2, wp=None, bp=None):
    c = x.shape[-1]
    m = x.numel() // c
    hidden, cout = w1.shape[0], w2.shape[0]
    params = [ln_w, ln_b, w1, b1, w2, b2] + ([wp, bp] if wp is not None else [])
    nbytes = x.element_size() * (x.numel() + m * cout) + sum(p.numel() * p.element_size() for p in params)
    flops = 2 * m * (c * hidden + hidden * cout + (c * cout if wp is not None else 0))
    return nbytes, flops


def _t2_cost(x, thw):
    return 3 * x.numel() * x.element_size(), 3 * 2 * x.numel()


def _whole_block_cost(rows, q_in, skip, k, v, weights, taps_flops):
    """Bytes: the block's activation inputs, K/V and weights read once, the
    output written once. Operations: the Q conv's taps, attention (4·Lk·C a
    row), proj (2·C²), fc1, fc2 and the dim-change proj."""
    wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2, wp, bp = weights[-10:]
    b, n, lk, hd = k.shape
    c, cout, hidden = wproj.shape[0], w2.shape[0], w1.shape[0]
    m = b * rows
    item = k.element_size()
    nbytes = (sum(t.numel() for t in (q_in, skip, k, v) if t is not None) + m * cout) * item
    nbytes += sum(t.numel() * t.element_size() for t in weights if isinstance(t, torch.Tensor))
    flops = m * (taps_flops + 4 * lk * c + 2 * c * c
                 + 2 * (c * hidden + hidden * cout + (c * cout if wp is not None else 0)))
    return nbytes, flops


def _block_cost(x, k, v, scale, *weights):
    c = x.shape[-1]
    return _whole_block_cost(x.shape[1], x, None, k, v, weights, 2 * c * c)  # Q = LN1(x)·Wq


def _pool_block_cost(q, thw, skip, k, v, scale, *weights):
    # 27 taps a channel (the grid's edges skip a few, not counted off)
    return _whole_block_cost(skip.shape[1], q, skip, k, v, weights, 2 * 27 * q.shape[-1])


def _decoder_block_cost(q, thw, stride, skip, k, v, scale, *weights):
    # sub-pixel phases: a stride-2 axis gives a fine token 1 or 2 taps (1.5 on
    # average), a stride-1 axis 3
    taps = float(np.prod([1.5 if s == 2 else 3.0 for s in stride]))
    return _whole_block_cost(skip.shape[1], q, skip, k, v, weights, 2 * taps * q.shape[-1])


KERNELS = {
    "attention": dict(
        module=ka, attr="fused_attention", plain=ka.fused_attention_plain,
        library=_attn_library, cost=_attn_cost, route="cuda",
        source="csts_torch/csrc/attention.cu",
        replaces="csts_tpu/kernels/attention.py:85 (_attn_kernel; pallas_call at :184)",
    ),
    "mlp_tail": dict(
        module=kb, attr="fused_mlp_tail", plain=kb.fused_mlp_tail_plain,
        library=None, cost=_tail_cost, route="cuda",
        source="csts_torch/csrc/mlp_tail.cu",
        replaces="csts_tpu/kernels/block.py:631 (_mlp_tail_kernel; pallas_call at :700)",
    ),
    "t2_upsample": dict(
        module=kup, attr="t2_upsample", plain=kup.t2_upsample_plain,
        library=_t2_library, cost=_t2_cost, route="cuda",
        source="csts_torch/csrc/upsample.cu",
        replaces="csts_tpu/kernels/upsample.py:60 (_t2_kernel; pallas_call at :183)",
    ),
    "block": dict(
        module=kb, attr="fused_block", plain=kb.fused_block_plain,
        library=None, cost=_block_cost, route="cuda",
        source="csts_torch/csrc/block.cu",
        replaces="csts_tpu/kernels/block.py:82 (_block_kernel; pallas_call at :250)",
    ),
    "pool_block": dict(
        module=kb, attr="fused_pool_block", plain=kb.fused_pool_block_plain,
        library=None, cost=_pool_block_cost, route="cuda",
        source="csts_torch/csrc/pool_block.cu",
        replaces="csts_tpu/kernels/block.py:1302 (_pool_block_kernel; pallas_call at :1528)",
    ),
    "decoder_block": dict(
        module=kb, attr="fused_decoder_block", plain=kb.fused_decoder_block_plain,
        library=None, cost=_decoder_block_cost, route="cuda",
        source="csts_torch/csrc/decoder_block.cu",
        replaces="csts_tpu/kernels/block.py:771 (_decoder_kernel; pallas_call at :1222)",
    ),
}
WHOLE_BLOCKS = ("block", "pool_block", "decoder_block")
WRAPPERS = {name: getattr(k["module"], k["attr"]) for name, k in KERNELS.items()}
CARD = ""  # nvidia-smi's name and power limit, printed beside every time


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _signature(args) -> tuple:
    return tuple(
        (tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor) else a for a in args)


def _clone(args) -> tuple:
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)


@contextlib.contextmanager
def recording(calls: dict):
    """Swap each wrapper for one that records a copy of the inputs of the
    first launch of every distinct signature, as they were at the launch
    (and counts launches per signature), then launches the real kernel. A
    whole-block kernel's record also keeps its block and the block's input,
    for the block's time through the K1+K2 route."""
    block_in: list = []
    block_forward = tmvit.MultiScaleBlock.forward

    def forward(self, x, thw, mask=None):
        block_in[:] = [self, x, thw]
        return block_forward(self, x, thw, mask)

    def make(name, fn):
        def rec(*args):
            sig = _signature(args)
            if sig not in calls[name]:
                ctx = None
                if name in WHOLE_BLOCKS:
                    ctx = (block_in[0], block_in[1].clone(), block_in[2])
                calls[name][sig] = [0, _clone(args), ctx]
            calls[name][sig][0] += 1
            return fn(*args)
        # the wrapper counts its launches on the module attribute of its own
        # name, which is this recorder while it is installed
        rec.launches = 0
        return rec
    try:
        tmvit.MultiScaleBlock.forward = forward
        for name, k in KERNELS.items():
            setattr(k["module"], k["attr"], make(name, WRAPPERS[name]))
        yield
    finally:
        tmvit.MultiScaleBlock.forward = block_forward
        for name, k in KERNELS.items():
            setattr(k["module"], k["attr"], WRAPPERS[name])


@contextlib.contextmanager
def plain_kernels():
    """The model's kernel calls go to the plain PyTorch versions (the reference run)."""
    try:
        for k in KERNELS.values():
            setattr(k["module"], k["attr"], k["plain"])
        yield
    finally:
        for name, k in KERNELS.items():
            setattr(k["module"], k["attr"], WRAPPERS[name])


def time_ms(fn, target_s: float = 0.05) -> float:
    """Mean ms per call over a run of calls, CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    est = max(time.perf_counter() - t0, 1e-6)
    reps = int(min(50, max(3, target_s / est)))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# device kernels by family, matched on the kernel name the profiler reports
FAMILIES = (
    ("K1 attention", ("attn_mma_kernel", "attn_f32_kernel")),
    ("K2 mlp_tail", ("mlp_tail_mma_kernel", "mlp_tail_f32_kernel")),
    ("K3 t2_upsample", ("t2_upsample_kernel",)),
    ("B3-B5 whole blocks", ("block_mma_kernel", "block_f32_kernel")),
    ("convolution", ("conv", "cudnn", "implicit", "dgrad", "fprop", "winograd")),
    ("matmul", ("gemm", "cutlass", "xmma", "matmul", "nvjet")),
    ("reduction", ("reduce",)),
    ("copy/layout", ("copy", "cat", "transpose", "permute", "index", "upsample")),
)


def profile_forward(fn, fwd_ms: float) -> dict:
    """Device time of one forward by kernel family (torch.profiler), and the
    device's idle share: of the profiled window, whose wall carries the
    profiler's own overhead, and of ``fwd_ms``, the unprofiled forward's time
    from back-to-back calls, where the host runs ahead of the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # one entry per device activity (the event list may repeat one), and the
    # busy time as the union of their intervals
    spans = {(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type == DeviceType.CUDA}
    by_name: dict = {}
    for name, start, end in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    busy, reach = 0.0, float("-inf")
    for _, start, end in sorted(spans, key=lambda s: s[1]):
        busy += max(0.0, end - max(start, reach)) / 1e3
        reach = max(reach, end)
    fam = {}
    for name, ms in by_name.items():
        low = name.lower()
        label = next((f for f, keys in FAMILIES if any(k in low for k in keys)), "elementwise/other")
        fam[label] = fam.get(label, 0.0) + ms
    out = {"wall_ms": wall_ms, "device_busy_ms": busy, "device_kernels": len(spans),
           "device_idle_share": (1 - busy / wall_ms) if busy else None,
           "device_idle_share_unprofiled": (1 - busy / fwd_ms) if busy else None,
           "families_ms": dict(sorted(fam.items(), key=lambda kv: -kv[1])),
           "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:16])}
    if not busy:
        log("  profiler: no device time reported")
    else:
        log(f"  profile: wall {wall_ms:.2f} ms, {len(spans)} device activities busy "
            f"{busy:.2f} ms, idle share {out['device_idle_share']:.3f} (of the unprofiled "
            f"{fwd_ms:.2f} ms forward {out['device_idle_share_unprofiled']:.3f}); " + ", ".join(
                f"{k} {v:.2f}" for k, v in out["families_ms"].items()))
        for name, ms in out["top_kernels_ms"].items():
            log(f"    {ms:8.3f} ms  {name[:110]}")
    return out


def _to_fp32(args):
    return tuple(a.float() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                 for a in args)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_kernels(calls_by_bucket: dict) -> dict:
    """Phase 3: every kernel against its plain version at every recorded shape."""
    report = {name: {"shapes": [], "max_abs_err": 0.0, "max_abs_err_fp32": 0.0}
              for name in KERNELS}
    failures = []
    for bucket, calls in calls_by_bucket.items():
        for name, sigs in calls.items():
            k = KERNELS[name]
            kern, plain = WRAPPERS[name], k["plain"]
            for sig, (count, args, ctx) in sigs.items():
                got = kern(*args)
                torch.cuda.synchronize()
                ref = plain(*args)
                err = _max_err(got, ref)
                bar = bf16_bar(name, ref)
                if not (err <= bar and bool(torch.isfinite(got.float()).all())):
                    ins = [float(a.float().abs().max()) for a in args if isinstance(a, torch.Tensor)]
                    failures.append(f"{name} bf16 bucket {bucket} {sig}: max|Δ| {err} > {bar}; "
                                    f"max|inputs| {ins}, max|kernel| {_max_err(got, 0 * got)}, "
                                    f"max|plain| {_max_err(ref, 0 * ref)}")
                args32 = _to_fp32(args)
                got32 = kern(*args32)
                torch.cuda.synchronize()
                ref32 = plain(*args32)
                err32 = _max_err(got32, ref32)
                bar32 = FP32_ATOL[name] + FP32_RTOL[name] * float(ref32.abs().max())
                if not err32 <= bar32:
                    failures.append(f"{name} fp32 bucket {bucket} {sig}: max|Δ| {err32} > {bar32}")
                del got, ref, got32, ref32, args32
                row = {"bucket": bucket, "signature": repr(sig), "launches_per_forward": count,
                       "max_abs_err": err, "bar": bar, "max_abs_err_fp32": err32,
                       "bar_fp32": bar32}
                if bucket == max(calls_by_bucket):
                    nbytes, flops = k["cost"](*args)
                    row.update(
                        ms=time_ms(lambda: kern(*args)),
                        plain_ms=time_ms(lambda: plain(*args)),
                        library_ms=(time_ms(lambda: k["library"](*args))
                                    if k["library"] is not None else None),
                        bytes=nbytes, flops=flops,
                        bytes_ms=nbytes / PEAK_BYTES_S * 1e3,
                        ops_ms=flops / PEAK_BF16_FLOPS * 1e3,
                    )
                    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
                    if ctx is not None:
                        # the whole block, phase 1 included, through this
                        # kernel and through the K1+K2 route
                        blk, x_in, thw = ctx
                        row["block_ms"] = time_ms(lambda: blk(x_in, thw))
                        row["composite_ms"] = time_ms(lambda: blk.forward_composite(x_in, thw))
                    log(f"  {name} {sig[0]} x{count}: {row['ms']:.4f} ms (plain "
                        f"{row['plain_ms']:.4f}, library {row['library_ms']}, bound "
                        f"{row['bound_ms']:.4f} = bytes {row['bytes_ms']:.4f} / ops "
                        f"{row['ops_ms']:.4f}"
                        + (f"; whole block {row['block_ms']:.4f} vs K1+K2 route "
                           f"{row['composite_ms']:.4f}" if ctx is not None else "")
                        + f") max|Δ| bf16 {err:.3g} fp32 {err32:.3g} ({CARD})")
                report[name]["shapes"].append(row)
                report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
                report[name]["max_abs_err_fp32"] = max(report[name]["max_abs_err_fp32"], err32)
    torch.cuda.empty_cache()
    assert not failures, "kernel vs plain:\n" + "\n".join(failures)
    return report


def make_inputs(rng: np.random.Generator, n: int, spec):
    t, s = spec.num_frames, spec.crop_size
    video = rng.standard_normal((n, t, s, s, 3), dtype=np.float32)
    audio = rng.standard_normal((n, t, s, s, 1), dtype=np.float32)
    return video, audio


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    global CARD
    t_start = time.perf_counter()
    card = CARD = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}")

    # --- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"phase build: {time.perf_counter() - t0:.2f} s for {sorted(logs)}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # --- phase 2: flagship model behind the predictor ------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = flagship_cfg()
    cfg.TRAIN.MIXED_PRECISION = True
    spec = build_spec(cfg)
    ref_model = CSTS(spec)
    init_params(ref_model, torch.Generator().manual_seed(SEED))
    state = ref_model.state_dict()
    t0 = time.perf_counter()
    pred = GazePredictor(cfg, state, batch_sizes=(1, 8))
    n_params = sum(p.numel() for p in pred.model.parameters())
    log(f"phase model: flagship {n_params / 1e6:.1f}M params bf16 on "
        f"{pred.device}, {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)
    calls_by_bucket = {}
    for bucket in pred.batch_sizes:
        calls = {name: {} for name in KERNELS}
        video, audio = make_inputs(rng, bucket, spec)
        t0 = time.perf_counter()
        with recording(calls):
            pred.predict(video, audio)
        torch.cuda.synchronize()
        calls_by_bucket[bucket] = calls
        log(f"phase warm-up bucket {bucket}: {time.perf_counter() - t0:.2f} s, distinct shapes "
            + ", ".join(f"{n} {len(s)}" for n, s in calls.items()))

    # --- phase 3: kernels against their plain versions ----------------------
    t0 = time.perf_counter()
    with torch.inference_mode():
        report = check_kernels(calls_by_bucket)
    del calls_by_bucket
    log(f"phase kernels: {time.perf_counter() - t0:.2f} s")

    # --- phase 4: the serving path -------------------------------------------
    requests = [make_inputs(rng, n, spec) for n in REQUESTS]
    # once untimed: the checks above emptied the allocator's cache
    for video, audio in requests:
        pred.predict(video, audio)
    for w in WRAPPERS.values():
        w.launches = 0
    outs, req_s = [], []
    for video, audio in requests:
        t0 = time.perf_counter()
        outs.append(pred.predict(video, audio))
        req_s.append(time.perf_counter() - t0)
    launches = {name: WRAPPERS[name].launches for name in KERNELS}
    log(f"phase serve: requests {list(REQUESTS)} in "
        + ", ".join(f"{s * 1e3:.1f} ms" for s in req_s) + f"; launches {launches}")
    for name, per in PER_FORWARD.items():
        need = per * len(REQUESTS)
        assert launches[name] == need, f"{name}: {launches[name]} launches, expected {need}"

    t_out = spec.num_frames
    hw = spec.crop_size // 4
    for n, out in zip(REQUESTS, outs):
        hm, xy = out["heatmaps"], out["gaze_xy"]
        assert hm.shape == (n, t_out, hw, hw), hm.shape
        assert xy.shape == (n, t_out, 2), xy.shape
        assert np.isfinite(hm).all() and np.isfinite(xy).all()
        sums = hm.reshape(n, t_out, -1).sum(-1)
        assert np.abs(sums - 1).max() < 1e-3, np.abs(sums - 1).max()

    # the same weights through the plain versions, fp32, on the card
    video, audio = requests[-1]
    v = torch.from_numpy(video).cuda()
    a = torch.from_numpy(audio).cuda()
    with torch.inference_mode():
        logits16 = pred.model(v, a).float()
    ref_model = ref_model.cuda().eval()
    with plain_kernels(), torch.inference_mode():
        logits32 = ref_model(v, a)
    ref_model.cpu()
    dlogit = float((logits16 - logits32).abs().max())
    sm16 = frame_softmax(logits16)
    sm32 = frame_softmax(logits32)
    dsm = float((sm16 - sm32).abs().max())
    dheat = float(np.abs(outs[-1]["heatmaps"] - sm32[..., 0].cpu().numpy()).max())
    flat32 = logits32.reshape(*logits32.shape[:2], -1)
    top2 = flat32.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * dlogit
    agree = (flat32.argmax(-1) == logits16.reshape(flat32.shape).argmax(-1))[decided]
    log(f"phase reference: logits max|Δ| {dlogit:.4g} (|logits| max "
        f"{float(logits32.abs().max()):.4g}), per-frame softmax max|Δ| {dsm:.3g}, "
        f"served heatmaps max|Δ| {dheat:.3g}, argmax agrees on "
        f"{int(agree.sum())}/{int(decided.sum())} decided frames of {decided.numel()}")
    assert dsm < 0.02 and dheat < 0.02, (dsm, dheat)
    assert bool(agree.all()), "argmax differs on a frame whose top-2 gap exceeds the error"
    del logits16, logits32, sm16, sm32, ref_model

    with torch.inference_mode():
        fwd_ms = time_ms(lambda: pred.forward(v, a), target_s=1.0)
    torch.cuda.reset_peak_memory_stats()
    pred.forward(v, a)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    breakdown = profile_forward(lambda: pred.forward(v, a), fwd_ms)
    log(f"phase timing: forward batch 8 bf16 {fwd_ms:.2f} ms = {8e3 / fwd_ms:.2f} clips/s, "
        f"peak memory {peak_gib:.2f} GiB ({card})")

    kernels = []
    for name, k in KERNELS.items():
        rows = [r for r in report[name]["shapes"] if "ms" in r]
        per = lambda key: sum(r[key] * r["launches_per_forward"] for r in rows)  # noqa: E731
        lib = (None if k["library"] is None else per("library_ms"))
        kernels.append({
            "name": name, "route": k["route"], "source": k["source"], "replaces": k["replaces"],
            "launches": launches[name], "max_abs_err": report[name]["max_abs_err"],
            "ms": per("ms"), "plain_ms": per("plain_ms"), "bound_ms": per("bound_ms"),
            "bound_by": "bytes" if per("bytes_ms") >= per("ops_ms") else "operations",
            "library_ms": lib,
            # the whole blocks, phase 1 included, through this kernel and
            # through the K1+K2 route (whole-block kernels only)
            "block_ms": per("block_ms") if name in WHOLE_BLOCKS else None,
            "composite_ms": per("composite_ms") if name in WHOLE_BLOCKS else None,
        })
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "per_shape": report,
                   "forward_ms_batch8": fwd_ms, "clips_per_s_batch8": 8e3 / fwd_ms,
                   "request_s": dict(zip(map(str, REQUESTS), req_s)),
                   "peak_gib": peak_gib, "logits_max_abs_diff": dlogit,
                   "softmax_max_abs_diff": dsm, "profile": breakdown}, f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

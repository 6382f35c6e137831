"""Entry points and measurement tools of the port: ``run_net`` (the JAX
package's ``tools/run_net.py``: test a checkpoint from a YAML), ``bench``
(its ``bench.py``), the counterparts of its ``tools/ab_block.py``,
``tools/ab_flags.py`` and ``tools/profile_forward.py``, and three of the
port's own: ``ab_kernels`` (K1, B4, B5, K2, B7 and B8 of two checkouts in
turns), ``b5_phases`` (B5's phase split from clock stamps) and
``tail_phases`` (K2's and B7's three kernels one by one, beside cuBLAS).
``run_net``, ``ab_block``, ``ab_flags`` and ``profile_forward`` run on CUDA
unless given ``--device cpu`` (``python -m csts_torch.tools.<name>
--help``); a CPU run checks that the tool runs and gives no device metric.
``bench`` and the last three need a card."""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Callable

import torch


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def mean_ms(fn: Callable[[], object], device: torch.device, iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def plain_twins():
    """The eval forward's kernel calls (K1, K2, K3, B3, B4, B5 and B9a) go to
    their plain PyTorch twins (the reference run on the card); the wrappers
    are restored on exit."""
    from csts_torch.kernels import attention as ka
    from csts_torch.kernels import block as kb
    from csts_torch.kernels import upsample as kup

    twins = ((ka, "fused_attention", ka.fused_attention_plain),
             (kb, "fused_mlp_tail", kb.fused_mlp_tail_plain),
             (kup, "t2_upsample", kup.t2_upsample_plain),
             (kup, "hw2_upsample", kup.hw2_upsample_plain),
             (kb, "fused_block", kb.fused_block_plain),
             (kb, "fused_pool_block", kb.fused_pool_block_plain),
             (kb, "fused_decoder_block", kb.fused_decoder_block_plain))
    saved = [getattr(module, attr) for module, attr, _ in twins]
    try:
        for module, attr, plain in twins:
            setattr(module, attr, plain)
        yield
    finally:
        for (module, attr, _), fn in zip(twins, saved):
            setattr(module, attr, fn)


@contextlib.contextmanager
def direct_launches():
    """The eval forward's kernel wrappers (K1, K2, K3, B3, B4, B5 and B9a)
    replaced by their custom ops' CUDA implementations, the launches the
    wrappers made directly before the kernels were registered as ops: the
    dispatcher's cost is the difference. CUDA tensors only; the wrappers are
    restored on exit."""
    from csts_torch.kernels import attention as ka
    from csts_torch.kernels import block as kb
    from csts_torch.kernels import upsample as kup

    direct = ((ka, "fused_attention", ka.fused_attention_cuda),
              (kb, "fused_mlp_tail", kb.fused_mlp_tail_cuda),
              (kup, "t2_upsample", kup.t2_upsample_cuda),
              (kup, "hw2_upsample", kup.hw2_upsample_cuda),
              (kb, "fused_block", kb.fused_block_cuda),
              (kb, "fused_pool_block", kb.fused_pool_block_cuda),
              (kb, "fused_decoder_block", kb.fused_decoder_block_cuda))
    saved = [getattr(module, attr) for module, attr, _ in direct]
    try:
        for module, attr, fn in direct:
            # a launch counts on the module attribute of the wrapper's name
            fn.launches = 0
            setattr(module, attr, fn)
        yield
    finally:
        for (module, attr, _), fn in zip(direct, saved):
            setattr(module, attr, fn)


# The result check of the bench, of ``chip_smoke.py``'s eval phase and of the
# card tests. The per-frame softmax bar is ``tests/test_golden_256.py``'s. At
# random weights the heatmaps are near flat (probabilities ~1/(h*w) ~ 2.4e-4
# at the flagship's 64x64), so that bar would pass a forward of other
# weights too; the logits carry the signal. Their bar is relative to the
# reference's largest |logit|: bf16 through the kernels against the fp32
# plain twins reads 0.010-0.026 at |logits| max 1.7 on the H100 (the bench
# at batches 1-128, the eval loop's worst of 38 batches: under 0.016 of
# it), weights from another seed differ by the logits' own size (2.6).
SOFTMAX_BAR = 0.02
LOGIT_BAR = 0.05


def heatmap_check(logits: torch.Tensor, ref_logits: torch.Tensor,
                  probs: torch.Tensor | None = None) -> dict:
    """A forward's logits (B, T, h, w, 1) and per-frame heatmaps (``probs``,
    by default ``frame_softmax(logits)``) against a reference's logits:
    ``softmax_check``'s readings, ``logits_max_abs_diff``, and ``ok`` when
    the logits lie within ``LOGIT_BAR`` of the reference's largest |logit|,
    the heatmaps within ``SOFTMAX_BAR``, at least one frame is decided and no
    decided frame's argmax moved by more than one pixel."""
    from csts_torch.train.losses import frame_softmax

    logits, ref_logits = logits.float(), ref_logits.float()
    res = softmax_check(frame_softmax(logits) if probs is None else probs,
                        frame_softmax(ref_logits))
    res["logits_max_abs_diff"] = float((logits - ref_logits).abs().max())
    res["logits_bar"] = LOGIT_BAR * float(ref_logits.abs().max())
    res["ok"] = (res["logits_max_abs_diff"] < res["logits_bar"]
                 and res["softmax_max_abs_diff"] < SOFTMAX_BAR
                 and res["decided_frames"] > 0 and res["argmax_off_on_decided"] == 0)
    return res


def check_line(res: dict) -> str:
    """``heatmap_check``'s readings on one line."""
    return (f"logits max|Δ| {res['logits_max_abs_diff']:.4g} (bar {res['logits_bar']:.4g}), "
            f"per-frame softmax max|Δ| {res['softmax_max_abs_diff']:.3g} (bar {SOFTMAX_BAR}), "
            f"argmax off by more than 1 px on {res['argmax_off_on_decided']} of "
            f"{res['decided_frames']} decided frames ({res['frames']} frames)")


def softmax_check(probs: torch.Tensor, ref: torch.Tensor) -> dict:
    """The bf16 bar of ``tests/test_golden_256.py`` on per-frame heatmaps
    (B, T, h, w[, 1]): max|Δ| of the probabilities, and each frame's argmax
    within one pixel of the reference's on the frames whose top-2 reference
    probabilities are more than twice that max|Δ| apart (``decided``: there
    no rounding within the max|Δ| can move the argmax; on a flatter frame it
    may move it anywhere)."""
    b, t, h, w = probs.shape[:4]
    p, r = probs.reshape(b, t, h * w).float(), ref.reshape(b, t, h * w).float()
    err = float((p - r).abs().max())
    top2 = r.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * err
    a, ra = p.argmax(-1), r.argmax(-1)
    near = ((a // w - ra // w).abs() <= 1) & ((a % w - ra % w).abs() <= 1)
    return {"softmax_max_abs_diff": err, "decided_frames": int(decided.sum()),
            "frames": decided.numel(), "argmax_off_on_decided": int((~near & decided).sum())}

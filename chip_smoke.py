#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``csts_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card (``nvidia-smi`` name and power limit) and the kernel build from
     ``csts_torch/csrc`` (seconds, registers per kernel, spills and wgmma
     serialisation warnings); 1b. the widths earlier slices could not run
     (``widths_phase``): K2 and B7 at widths off 16, K1 and B8 at bf16 head
     dims 256, 384, 448 and 512 and at fp32 head dims 256, 320 and 448, a
     decoder block of dim 768 with three heads of 256
     (no whole-block instance fits it: routed to K1+K2 before any launch),
     and B4 at a width without a split instance, each against its plain
     version with its launches counted;
  2. the flagship CSTS-B 16x4 (256², 16+4 blocks, bf16) with seeded random
     weights behind a ``GazePredictor(batch_sizes=(1, 8))``; one warm-up
     request per bucket records the inputs of every kernel launch;
  3. each kernel (K1 attention, K2 MLP tail, K3 T×2 upsample, and the
     whole-block kernels B3 block, B4 pool_block, B5 decoder_block) against
     its plain PyTorch version at every distinct shape the forward launched
     it with, in bf16 and in fp32 (TF32 off), K1 also against the plain
     model of its key split where it splits the keys; at the batch-8 shapes
     the kernel's, the plain version's and one library call's time (CUDA
     events over back-to-back calls, host cost included), the kernel's and
     the library call's device time (``device_ms``: summed durations from
     ``torch.profiler``), and for the whole-block kernels the same block
     through the K1+K2 route (CUDA events and device time);
  4. the serving path: three requests (1, 5 and 8 clips) once to warm up,
     then launch counters set to 0, the same requests timed, counters read
     (each must equal its launches per forward times 3); outputs checked
     (shapes, finite, each frame's heatmap sums to 1) and held against the
     same weights through the plain versions in fp32 on the card; the
     batch-8 forward timed and profiled (device time by kernel family);
     then, under the same predictor, the hw2 path (``ab_flags``'s
     ``hw2_skip``): launch counters set to 0, one batch-8 forward with the
     switch on and one with it off, counters read (B9a ``hw2_upsample`` 2
     and 0, every other kernel as above), B9a against its plain version at
     d2's and d3's shapes (bf16, fp32) with its, the plain version's and
     ``F.interpolate``'s times, the forward with the switch on and off in
     turns, and the two forwards' per-frame softmax compared;
     the blocks path (``ab_block``'s five stacks at batch 8): counters set
     to 0 before and read after each stack's run through the whole-block
     kernel, the kernel against its plain version at every shape of the
     4-head, 384->768 and 8-head stacks (B9b/B9c, bf16 and fp32) with
     times and bounds, and every stack timed through the kernel and
     through the K1+K2 route;
  4d. the eval entry point: ``csts_torch.eval.tester.test`` at flagship
     width (bf16, ``TEST.BATCH_SIZE`` 8) on a synthetic test split of 20
     clips (150 frames, 256x320, npy backend) listed 15 times (300 rows),
     written to a temporary directory, from a ``.pyth`` saved from seeded
     weights: launch counters set to 0, the loop run, counters read (each
     its launches per forward times the batches); the rows scored against
     the split; the loop's logits and heatmaps against the same batches
     through the fp32 plain twins (``csts_torch.tools.heatmap_check``:
     logits within 0.05 of the largest |logit|, per-frame softmax max|Δ| <
     0.02, at least one decided frame, argmax within 1 px on decided
     frames), and the same check made to reject the first batch against
     weights from another seed (a planted fault); its whole-set F1, recall,
     precision, threshold and AUC against a float64 numpy twin on the same
     predictions (1e-6, same threshold); the start-up (test() called to the
     first batch in hand) and, after the first batch, clips/s with the
     loader, the consumer's wait share and the forwards' share printed;
  5. the training path: the flagship from ``flagship_train_cfg`` (fp32
     master weights, bf16 compute, batch 8, kldiv+egonce, AdamW, drop-path
     0.2) through ``make_train_step``: one warm-up step records the inputs of
     every B7 forward (``mlp_tail_train``), B7 backward and B8
     (``attention_bwd``) call, then launch counters set to 0, three steps
     timed with CUDA events, counters read (per step: K1 26, K3 2, B7 26, B8
     25); loss, grad norm and lr finite per step; the step profiled;
  6. B7 and B8 against their plain versions at every recorded shape (B7's
     out and stored hidden; B8's dq, dk, dv; B7's hand-written backward
     against autograd of its plain version), with times, bounds and B8's
     library time (the backward of ``F.scaled_dot_product_attention``), B8
     run twice at each shape (the two runs bit-equal);
     one fp32 step at batch 2 (TF32 off) through the kernels and through the
     plain twins from the same weights, masks and batch (loss and every
     parameter's gradient compared); one bf16 batch-8 step with the plain
     attention twin in place of K1+B8, timed beside the kernels' step;
  7. the training entry point: ``csts_torch.tools.run_net.main`` with
     ``--cfg configs/Ego4D/CSTS_Ego4D_Gaze_Forecast.yaml`` (read by the
     port's own YAML reader) at full width, bf16 over fp32 masters, batch 8,
     2 epochs of 6 iterations on a synthetic split in a temporary directory
     (12 clips; 48 train rows, 16 val/test rows), initialised by the yaml's
     recipe from seeded ``.pyth`` files (a video MViT at crop 224, whose
     position embedding is resampled, and an audio MViT merged into the
     audio branch; CHECKPOINT_EPOCH_RESET), validating each epoch, then
     testing the npz it wrote: launch counters set to 0 before and read
     after (K1, B8, B7 and K3 at their launches per step, every step; K2
     and B3-B5 in validation and test), each iteration's time, the loader's
     wait share, checkpoint save and load seconds and GB, peak memory; the
     npz's JAX layout (3P+4 leaves shaped as ``param_leaf_names``); a second
     uninterrupted run, then the preemption drill (SIGTERM injected after 3
     iterations, an iter-tagged save, auto-resume to the end) held to the
     two runs' spread, bit-equal where they are; beside it the raw step
     with ACT_CHECKPOINT on and off at batch 8 and with accum_steps 2 of 8
     against one pass of 16 (ms, peak memory), and both in fp32 at batch 16
     at the whole-step bars.
It prints the ``kernels`` JSON line, the card line and, last, the result line.
Per-shape details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
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
from csts_torch.ops import sample_drop_masks  # noqa: E402
from csts_torch.presets import flagship_cfg, flagship_train_cfg  # noqa: E402
from csts_torch.serving import GazePredictor  # noqa: E402
from csts_torch.tools import ab_block, ab_flags, card_line, plain_twins  # noqa: E402
from csts_torch.tools.ab_kernels import b4_inputs, tail_inputs  # noqa: E402
from csts_torch.tools.profile_forward import device_ms, device_trace, profile_forward  # noqa: E402
from csts_torch.train import step as train_lib  # noqa: E402
from csts_torch.train.losses import frame_softmax  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 tensor-core
# FLOP/s and fp32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

SEED = 0
REQUESTS = (1, 5, 8)
# launches per forward on the flagship: B3 takes v0, a0 and v2, B4 v1, v3, a1
# and a2, B5 d2-d4; the 16 other blocks (the two fusion blocks among them) run
# K1 and K2; K3 serves d4's skip and the head's stem skip; B9a only with the
# JAX package's switch HW2_SKIP_KERNEL set (off by default), then d2's and
# d3's skips (d1's skip is on the K1+K2 route, where JAX does not read it)
PER_FORWARD = {"attention": 16, "mlp_tail": 16, "t2_upsample": 2,
               "block": 3, "pool_block": 4, "decoder_block": 3, "hw2_upsample": 0}
HW2_PER_FORWARD = 2
BLOCK_BATCH = 8  # ab_block's stacks in the blocks phase

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
#        max|ref|): the same two-tap fp32 formula, each product and the sum
#        rounded on their own on both sides (no fused multiply-add in the
#        kernel), so they agree bit for bit unless a compiler fuses a product
#        into the sum.
#  B3, B4, B5 (whole blocks): fp32 the CPU bars of tests/test_torch_blocks.py
#        (B3 3e-5, B4 and B5 5e-5, each + 1e-4 relative). bf16 four ulps of the
#        largest output, 2**-5·max(1, max|ref|): both sides round LN1, q, the
#        probabilities, av, LN2 and the hidden at the same points, but the
#        kernel rounds the probabilities unnormalised (as K1, whose bar is
#        3e-2) and sums in another order, so a rounding of q or av may flip;
#        res1 is fp32 on both sides and adds no rounding of its own.
#  B9a (hw2_upsample): K3's bars. Both sides compute each pass's two products
#        and their sum rounded separately, copy the clamped edges and round
#        the H pass to the dtype before the W pass, so they agree bit for
#        bit unless a compiler fuses a product into the sum.
#  B9b/B9c (the whole-block kernel at 3-8 heads): B3's bars, the same kernel.
FP32_ATOL = {"attention": 2e-5, "mlp_tail": 3e-5, "t2_upsample": 1e-6,
             "block": 3e-5, "pool_block": 5e-5, "decoder_block": 5e-5}
FP32_RTOL = {"attention": 0.0, "mlp_tail": 1e-4, "t2_upsample": 0.0,
             "block": 1e-4, "pool_block": 1e-4, "decoder_block": 1e-4}


#  B7 (mlp_tail_train): K2's bars for out and for the stored hidden (the same
#        rounding points as K2: LN2(x), the fp32 fc1 sum rounded once, the
#        GELU, the output once; a summation order can flip one rounding).
#  B8 (attention_bwd), each of dq, dk, dv against max|ref| of its own:
#        fp32 1e-4·max(1, max|ref|) at the ragged shapes of the card tests,
#        whose gradients are O(1), and 1e-4·max|ref| at the flagship's, whose
#        gradients are far below 1 (both sides exact fp32 up to summation
#        order over up to 32768 rows, and an lse from K1's online softmax in
#        place of the plain version's one-pass softmax); bf16 2**-5 (four
#        ulps) of the same scale: both sides round p and dl to bf16 before
#        the products at the same points, but p is rebuilt from K1's lse,
#        one fp32 ulp from the plain softmax, which can flip a rounding of p
#        or dl, and the sums run in another order before the output's one
#        rounding.
#  B7's backward against autograd of its plain version: the relative norm
#        ‖Δ‖/‖ref‖ of each gradient. fp32 1e-4: both exact fp32, but a weight
#        gradient sums up to 262144 rows with cancellation, in another order
#        on each side (1.1e-5 measured at 1024 rows). bf16 2e-2 for dx and
#        the weight matrices: the hand-written backward rounds its products'
#        operands to bf16 (fp32 out) and takes GELU from the stored bf16
#        hidden, autograd of the plain version rounds the cotangents at its
#        casts instead; each side is a few bf16 ulps (2**-8) from exact. bf16
#        1e-1 for the vectors (biases, LN2's weight and bias): each sums a
#        column over up to 262144 rows and ends far smaller than its terms,
#        so the two sides' different roundings of the terms show relatively
#        larger (LN2's bias at d4: 0.025 measured, 0.0037 for its dx).
B8_BAR = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}
B7_BWD_BAR = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
B7_BWD_VECTOR_BAR = {torch.float32: 1e-4, torch.bfloat16: 1e-1}
#  The fp32 whole step: loss within 1e-5 relative, each parameter's gradient
#        within 1e-3 in relative norm (fp32 on both sides, TF32 off; the
#        kernels sum in other orders over up to 32768 rows), plus 1e-6 of the
#        whole gradient's norm: the pooled keys' norm biases have an exact
#        gradient of 0 (the softmax ignores a shift shared by all keys), so
#        both sides give rounding noise there and their ratio means nothing.
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_GRAD_FLOOR = 1e-5, 1e-3, 1e-6


def bf16_bar(name: str, ref: torch.Tensor) -> float:
    scale = max(1.0, float(ref.float().abs().max()))
    return {"attention": 3e-2 * scale, "mlp_tail": 2.0 ** -6 * scale,
            "t2_upsample": 2.0 ** -7 * scale, "block": 2.0 ** -5 * scale,
            "pool_block": 2.0 ** -5 * scale, "decoder_block": 2.0 ** -5 * scale,
            "mlp_tail_train": 2.0 ** -6 * scale}[name]


def split_bar(ref: torch.Tensor) -> float:
    """K1's bf16 body against the plain model of its key split and merge:
    one bf16 ulp of the largest output, 2**-7·max|ref|, plus 1e-3. Both round
    the same values at the same points (p unnormalised per split, the output
    once) and differ only in fp32 summation order and exp2 against exp, which
    can flip one rounding; the floor of 1 in K1's own bar is dropped, so a
    merge that weights a split wrongly shows at Lk 1024, where the outputs
    are averages far below 1."""
    return 2.0 ** -7 * float(ref.float().abs().max()) + 1e-3


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """‖got − ref‖ / ‖ref‖ in fp32 (0 when both are 0)."""
    num = float(torch.linalg.vector_norm(got.float() - ref.float()))
    den = float(torch.linalg.vector_norm(ref.float()))
    return num / den if den else (0.0 if num == 0 else float("inf"))


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


def _tail_cublas(x, ln_w, ln_b, w1, b1, w2, b2, wp=None, bp=None, *_):
    """The tail's products alone as cuBLAS runs them (``torch.mm`` of fc1, fc2
    and the dim-change proj on operands of the same shapes and dtype): a
    yardstick for K2's and B7's products, not the same function (no LN2,
    GELU, biases or base), so not their ``library_ms``."""
    x2 = x.reshape(-1, x.shape[-1])
    g = torch.empty((x2.shape[0], w1.shape[0]), dtype=x.dtype, device=x.device)

    def run():
        torch.mm(x2, w1.t())
        torch.mm(g, w2.t())
        if wp is not None:
            torch.mm(x2, wp.t())
    return run


def _t2_cost(x, thw):
    return 3 * x.numel() * x.element_size(), 3 * 2 * x.numel()


def _hw2_library(x, thw):
    b, l, c = x.shape
    grid = x.reshape(b, *thw, c).permute(0, 4, 1, 2, 3)
    return F.interpolate(grid, scale_factor=(1, 2, 2), mode="trilinear", align_corners=False)


def _hw2_cost(x, thw):
    """x read once, the 4x output written once; 3 fp32 operations (two
    products and a sum) per H-pass value (2 per input) and per output (4)."""
    return 5 * x.numel() * x.element_size(), 3 * 6 * x.numel()


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


def _block_cost(x, k, v, scale, ln1_w, ln1_b, wq, bq, *rest):
    # Q = LN1(x)·Wq from phase 1's LN1 rows xn (the last argument, when given)
    c = x.shape[-1]
    xn = rest[10] if len(rest) > 10 else None
    return _whole_block_cost(x.shape[1], x, xn, k, v, (ln1_w, ln1_b, wq, bq, *rest[:10]),
                             2 * c * c)


def _pool_block_cost(q, thw, skip, k, v, scale, *weights):
    # 27 taps a channel (the grid's edges skip a few, not counted off)
    return _whole_block_cost(skip.shape[1], q, skip, k, v, weights, 2 * 27 * q.shape[-1])


def _decoder_block_cost(q, thw, stride, skip, k, v, scale, *weights):
    # sub-pixel phases: a stride-2 axis gives a fine token 1 or 2 taps (1.5 on
    # average), a stride-1 axis 3
    taps = float(np.prod([1.5 if s == 2 else 3.0 for s in stride]))
    return _whole_block_cost(skip.shape[1], q, skip, k, v, weights, 2 * taps * q.shape[-1])


def _tail_train_cost(x, ln_w, ln_b, w1, b1, w2, b2, wp, bp, dp):
    """K2's bytes and operations, plus the stored hidden written once and dp."""
    nbytes, flops = _tail_cost(x, ln_w, ln_b, w1, b1, w2, b2, wp, bp)
    m = x.numel() // x.shape[-1]
    return nbytes + m * w1.shape[0] * x.element_size() + 4 * dp.numel(), flops


def _attn_bwd_cost(q, k, v, out, g, scale, lse=None):
    """Bytes: q, out, g read and dq written (Lq·hd each), k, v read and dk,
    dv written (Lk·hd each), the lse row read. Operations: the five products
    q kᵀ, g vᵀ, dl k, dlᵀ q, pᵀ g of 2·Lq·Lk·hd each."""
    b, n, lq, hd = q.shape
    lk = k.shape[2]
    nbytes = q.element_size() * (4 * b * n * lq * hd + 4 * b * n * lk * hd) + 4 * b * n * lq
    return nbytes, 10 * b * n * lq * lk * hd


def _attn_bwd_library(q, k, v, out, g, scale, lse=None):
    """One backward of ``F.scaled_dot_product_attention`` at the same shapes,
    its graph built once, ready to time."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        o = F.scaled_dot_product_attention(*leaves, scale=scale)
    return lambda: torch.autograd.grad(o, leaves, g, retain_graph=True)


KERNELS = {
    "attention": dict(
        module=ka, attr="fused_attention", plain=ka.fused_attention_plain,
        library=_attn_library, cost=_attn_cost, route="cuda",
        source="csts_torch/csrc/attention.cu",
        replaces="csts_tpu/kernels/attention.py:85 (_attn_kernel; pallas_call at :184)",
    ),
    "mlp_tail": dict(
        module=kb, attr="fused_mlp_tail", plain=kb.fused_mlp_tail_plain,
        library=None, cost=_tail_cost, route="cuda", yardstick=_tail_cublas,
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
# the training path's kernels; library() builds a callable to time, or None
TRAIN_KERNELS = {
    "mlp_tail_train": dict(
        module=kb, attr="fused_mlp_tail_train", plain=kb.fused_mlp_tail_train_plain,
        library=None, cost=_tail_train_cost, route="cuda", yardstick=_tail_cublas,
        source="csts_torch/csrc/mlp_tail_train.cu",
        replaces="csts_tpu/kernels/block.py:1579 (_mlp_tail_train_kernel; pallas_call at :1635)",
    ),
    "attention_bwd": dict(
        module=ka, attr="fused_attention_bwd", plain=ka.fused_attention_bwd_plain,
        library=_attn_bwd_library, cost=_attn_bwd_cost, route="cuda",
        source="csts_torch/csrc/attention_bwd.cu",
        replaces="csts_tpu/kernels/attention.py:205 (_flash_bwd_kernel; pallas_call at :319)",
    ),
}
ALL_KERNELS = {**KERNELS, **TRAIN_KERNELS}
# the paths of the JAX package's experiment entry points: B9a behind the
# hw2_skip switch (ab_flags), and the whole-block kernel at 3-8 heads (B9b and
# B9c, one kernel: B3's wrapper and library) on ab_block's stacks; ``bars``
# names the kernel whose bars they take, ``peak`` the peak rate of their
# operations (default bf16)
B9_KERNELS = {
    "hw2_upsample": dict(
        module=kup, attr="hw2_upsample", plain=kup.hw2_upsample_plain,
        library=_hw2_library, cost=_hw2_cost, route="cuda", peak=PEAK_F32_FLOPS,
        bars="t2_upsample",
        source="csts_torch/csrc/upsample.cu", path="ab_flags",
        replaces="csts_tpu/kernels/upsample.py:100 (_hw2_kernel; pallas_call at :160)",
    ),
    "block_multihead": dict(
        module=kb, attr="fused_block", plain=kb.fused_block_plain,
        library=None, cost=_block_cost, route="cuda", bars="block",
        source="csts_torch/csrc/block.cu", path="ab_block",
        replaces="csts_tpu/kernels/block.py:276 (_block_hg_kernel; pallas_call at :434), "
                 "csts_tpu/kernels/block.py:449 (_block_bd_kernel; pallas_call at :554)",
    ),
}
COUNTED = {**ALL_KERNELS, **B9_KERNELS}
# recorded beside them: B7's hand-written backward (PyTorch, no kernel of its own)
RECORDED = {**COUNTED,
            "mlp_tail_train_bwd": dict(module=kb, attr="fused_mlp_tail_train_bwd")}
WRAPPERS = {name: getattr(k["module"], k["attr"]) for name, k in RECORDED.items()}
# the training route's autograd entries, and autograd of their plain twins
TRAIN_ENTRIES = (
    (ka, "attention_train",
     lambda q, k, v, scale, mask=None: ka.fused_attention_plain(q, k, v, scale, mask)),
    (kb, "mlp_tail_train", lambda *a: kb.fused_mlp_tail_train_plain(*a)[0]),
    (kup, "t2_upsample_train", kup.t2_upsample_plain),
)
# launches per training step on the flagship: K1 forward and B7 at all 26
# blocks (16 video, 4 audio, 2 fusion, 4 decoder), B8 at the 25 without a
# mask (the spatial fusion's backward is the plain recompute), K3 at d4's
# skip and the stem skip; K2 and B3-B5 are eval only
PER_STEP = {"attention": 26, "mlp_tail_train": 26, "attention_bwd": 25, "t2_upsample": 2,
            "mlp_tail": 0, "block": 0, "pool_block": 0, "decoder_block": 0, "hw2_upsample": 0}
TRAIN_STEPS = 3
STEPS_PER_EPOCH = 1000  # the lr schedule's epoch is step / STEPS_PER_EPOCH
CARD = ""  # nvidia-smi's name and power limit, printed beside every time


def log(msg: str) -> None:
    print(msg, flush=True)


def _signature(args) -> tuple:
    return tuple(
        (tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor) else a for a in args)


def _clone(args) -> tuple:
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)


@contextlib.contextmanager
def recording(calls: dict):
    """Swap the wrapper of each name in ``calls`` for one that records a copy
    of the inputs of the first launch of every distinct signature, as they
    were at the launch (and counts launches per signature), then launches
    the real kernel. A whole-block kernel's record also keeps its block and
    the block's input, for the block's time through the K1+K2 route."""
    block_in: list = []
    block_forward = tmvit.MultiScaleBlock.forward

    def forward(self, x, thw, mask=None, drop=None):
        block_in[:] = [self, x, thw]
        return block_forward(self, x, thw, mask, drop)

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
        for name in calls:
            setattr(RECORDED[name]["module"], RECORDED[name]["attr"], make(name, WRAPPERS[name]))
        yield
    finally:
        tmvit.MultiScaleBlock.forward = block_forward
        for name in calls:
            setattr(RECORDED[name]["module"], RECORDED[name]["attr"], WRAPPERS[name])


@contextlib.contextmanager
def train_twins(attrs=tuple(attr for _, attr, _ in TRAIN_ENTRIES)):
    """The training route's autograd entries named in ``attrs`` replaced by
    autograd of their plain twins (the reference run)."""
    saved = {}
    try:
        for module, attr, plain in TRAIN_ENTRIES:
            if attr in attrs:
                saved[(module, attr)] = getattr(module, attr)
                setattr(module, attr, plain)
        yield
    finally:
        for (module, attr), fn in saved.items():
            setattr(module, attr, fn)


def reset_launches() -> None:
    for name in COUNTED:
        WRAPPERS[name].launches = 0


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


def _to_fp32(args):
    return tuple(a.float() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                 for a in args)


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_kernels(calls_by_bucket: dict, kernels: dict = KERNELS) -> dict:
    """Phase 3: every kernel of ``kernels`` against its plain version at every
    recorded shape (a kernel's ``bars`` name the bars it takes, its ``peak``
    the peak rate of its operations)."""
    report = {name: {"shapes": [], "max_abs_err": 0.0, "max_abs_err_fp32": 0.0}
              for name in kernels}
    failures = []
    for bucket, calls in calls_by_bucket.items():
        for name, sigs in calls.items():
            k = kernels[name]
            kern, plain = WRAPPERS[name], k["plain"]
            bars = k.get("bars", name)
            for sig, (count, args, ctx) in sigs.items():
                got = kern(*args)
                torch.cuda.synchronize()
                ref = plain(*args)
                err = _max_err(got, ref)
                bar = bf16_bar(bars, ref)
                if not (err <= bar and bool(torch.isfinite(got.float()).all())):
                    ins = [float(a.float().abs().max()) for a in args if isinstance(a, torch.Tensor)]
                    failures.append(f"{name} bf16 bucket {bucket} {sig}: max|Δ| {err} > {bar}; "
                                    f"max|inputs| {ins}, max|kernel| {_max_err(got, 0 * got)}, "
                                    f"max|plain| {_max_err(ref, 0 * ref)}")
                split = {}
                if name == "attention":
                    # K1's key split against the plain model of the split and merge
                    q, k_ = args[0], args[1]
                    splits = ka.key_splits(q.shape[0] * q.shape[1], q.shape[2], k_.shape[2],
                                           torch.cuda.get_device_properties(0).multi_processor_count)
                    split["splits"] = splits
                    if splits > 1:
                        ref_s = ka.fused_attention_split_plain(*args[:4], splits, *args[4:])
                        split["max_abs_err_split"] = _max_err(got, ref_s)
                        if not split["max_abs_err_split"] <= split_bar(ref_s):
                            failures.append(f"{name} split {splits} bucket {bucket} {sig}: max|Δ| "
                                            f"{split['max_abs_err_split']} vs the split model")
                        del ref_s
                args32 = _to_fp32(args)
                got32 = kern(*args32)
                torch.cuda.synchronize()
                ref32 = plain(*args32)
                err32 = _max_err(got32, ref32)
                bar32 = FP32_ATOL[bars] + FP32_RTOL[bars] * float(ref32.abs().max())
                if not err32 <= bar32:
                    failures.append(f"{name} fp32 bucket {bucket} {sig}: max|Δ| {err32} > {bar32}")
                del got, ref, got32, ref32, args32
                row = {"bucket": bucket, "signature": repr(sig), "launches_per_forward": count,
                       "max_abs_err": err, "bar": bar, "max_abs_err_fp32": err32,
                       "bar_fp32": bar32, **split}
                if bucket == max(calls_by_bucket):
                    nbytes, flops = k["cost"](*args)
                    row.update(
                        ms=time_ms(lambda: kern(*args)),
                        plain_ms=time_ms(lambda: plain(*args)),
                        library_ms=(time_ms(lambda: k["library"](*args))
                                    if k["library"] is not None else None),
                        device_ms=device_ms(lambda: kern(*args)),
                        library_device_ms=(device_ms(lambda: k["library"](*args))
                                           if k["library"] is not None else None),
                        bytes=nbytes, flops=flops,
                        bytes_ms=nbytes / PEAK_BYTES_S * 1e3,
                        ops_ms=flops / k.get("peak", PEAK_BF16_FLOPS) * 1e3,
                    )
                    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
                    if k.get("yardstick") is not None:
                        run = k["yardstick"](*args)
                        row.update(cublas_ms=time_ms(run), cublas_device_ms=device_ms(run))
                    if ctx is not None:
                        # the whole block, phase 1 included, through this
                        # kernel and through the K1+K2 route
                        blk, x_in, thw = ctx
                        row["block_ms"] = time_ms(lambda: blk(x_in, thw))
                        row["composite_ms"] = time_ms(lambda: blk.forward_composite(x_in, thw))
                        row["block_device_ms"] = device_ms(lambda: blk(x_in, thw))
                        row["composite_device_ms"] = device_ms(
                            lambda: blk.forward_composite(x_in, thw))
                    log(f"  {name} {sig[0]} x{count}: {row['ms']:.4f} ms, device "
                        f"{row['device_ms']:.4f} (plain {row['plain_ms']:.4f}, library "
                        f"{row['library_ms']} / device {row['library_device_ms']}, bound "
                        f"{row['bound_ms']:.4f} = bytes {row['bytes_ms']:.4f} / ops "
                        f"{row['ops_ms']:.4f}"
                        + (f"; whole block {row['block_ms']:.4f} (device "
                           f"{row['block_device_ms']:.4f}) vs K1+K2 route "
                           f"{row['composite_ms']:.4f} (device {row['composite_device_ms']:.4f})"
                           if ctx is not None else "")
                        + (f"; cuBLAS products {row['cublas_ms']:.4f} / device "
                           f"{row['cublas_device_ms']:.4f}" if "cublas_ms" in row else "")
                        + f") max|Δ| bf16 {err:.3g} fp32 {err32:.3g} ({CARD})")
                report[name]["shapes"].append(row)
                report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
                report[name]["max_abs_err_fp32"] = max(report[name]["max_abs_err_fp32"], err32)
    torch.cuda.empty_cache()
    assert not failures, "kernel vs plain:\n" + "\n".join(failures)
    return report


def _randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def widths_phase() -> dict:
    """Phase 1b: the widths the earlier slices could not run (ROADMAP Queue
    C), each kernel against its plain twin on the card at its bar, the
    wrapper's launch counted: K2 and B7 at widths off 16 (zero-padded to 16,
    LN2 over the true width); K1 and B8 at bf16 head dims 256 and 384 (the
    output columns split over blocks), and their streamed bodies at bf16
    head dims 448 and 512 and at fp32 head dims 256, 320 and 448 (the
    head dim streamed in 64-column steps); a decoder block of dim 768 with three
    heads of 256, which fits no whole-block instance and takes K1+K2 (its
    route read before any launch), against the same block through the plain
    twins; B4 at a width without a split instance (the first design's
    body)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, failures = [], []

    def check(tag, name, got, want, bar):
        err = _max_err(got, want)
        ok = err <= bar and bool(torch.isfinite(got.float()).all())
        rows.append({"case": tag, "kernel": name, "max_abs_err": err, "bar": bar,
                     "launches": WRAPPERS[name].launches})
        log(f"  {tag}: {name} max|Δ| {err:.3g} (bar {bar:.3g}), {WRAPPERS[name].launches} "
            f"launches" + ("" if ok else "  FAIL"))
        if not ok or WRAPPERS[name].launches < 1:
            failures.append(f"{tag} {name}: max|Δ| {err} bar {bar}, launches "
                            f"{WRAPPERS[name].launches}")

    # the block that fits no whole-block instance, random weights from the seed
    spec = tmvit.AttentionSpec(dim=768, dim_out=384, num_heads=3, kernel_q=(3, 3, 3),
                               kernel_kv=(3, 3, 3), stride_q=(1, 2, 2), stride_kv=(1, 1, 1),
                               upsample_q=True)
    blk = tmvit.MultiScaleBlock(spec)
    pgen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for prm in blk.parameters():
            prm.copy_(torch.randn(prm.shape, generator=pgen) * 0.05)
    blk = blk.cuda().to(torch.bfloat16).eval()
    with torch.inference_mode():
        dp = torch.tensor([0.0, 1.25, 1, 1, 1, 1, 1, 1], device="cuda")
        for n_rows, c, h, cout in ((37, 40, 160, 72), (50, 40, 160, 40), (300, 200, 792, 200)):
            args = tail_inputs(n_rows, c, h, cout, gen)
            tag = f"C {c} / H {h} / C_out {cout}"
            reset_launches()
            got = kb.fused_mlp_tail(*args)
            want = kb.fused_mlp_tail_plain(*args)
            check(tag, "mlp_tail", got, want, bf16_bar("mlp_tail", want))
            reset_launches()
            out, hid = kb.fused_mlp_tail_train(*args, dp)
            want_o, want_h = kb.fused_mlp_tail_train_plain(*args, dp)
            check(tag, "mlp_tail_train", out, want_o, bf16_bar("mlp_tail_train", want_o))
            check(tag + " (hidden)", "mlp_tail_train", hid, want_h,
                  bf16_bar("mlp_tail_train", want_h))
        # K1 and B8: bf16 head dims 256 and 384 (the output columns split
        # over blocks), the streamed bodies at bf16 448 and 512 and at fp32
        # 256, 320 and 448 (the exactness check, any head dim)
        for dt, b, n, lq, lk, hd in ((torch.bfloat16, 2, 3, 200, 130, 256),
                                     (torch.bfloat16, 2, 2, 150, 70, 384),
                                     (torch.bfloat16, 1, 2, 75, 130, 448),
                                     (torch.bfloat16, 1, 2, 40, 70, 512),
                                     (torch.float32, 2, 2, 90, 70, 256),
                                     (torch.float32, 1, 2, 75, 130, 320),
                                     (torch.float32, 1, 2, 40, 70, 448)):
            q, k, v = (_randn(gen, b, n, m, hd, dtype=dt) for m in (lq, lk, lk))
            g = _randn(gen, b, lq, n, hd, dtype=dt).permute(0, 2, 1, 3)
            scale = hd ** -0.5
            body = "streamed" if ka.streamed(hd, dt) else "wgmma"
            tag = (f"head dim {hd} {str(dt)[6:]} ({body}; B {b}, N {n}, Lq {lq}, Lk {lk}; "
                   f"runs at {ka.kernel_head_dim(hd, dt)})")
            reset_launches()
            out = ka.fused_attention(q, k, v, scale)
            want = ka.fused_attention_plain(q, k, v, scale)
            check(tag, "attention", out, want,
                  bf16_bar("attention", want) if dt == torch.bfloat16 else FP32_ATOL["attention"])
            out, lse = ka._attention_fwd(q, k, v, scale, None, with_lse=True)
            reset_launches()
            got = ka.fused_attention_bwd(q, k, v, out, g, scale, lse)
            want = ka.fused_attention_bwd_plain(q, k, v, out, g, scale)
            for part, x, y in zip(("dq", "dk", "dv"), got, want):
                check(f"{tag} {part}", "attention_bwd", x, y,
                      B8_BAR[dt] * max(1.0, float(y.float().abs().max())))
        thw = (4, 8, 8)
        route = tmvit.block_route(spec, None, thw)
        assert route == "composite", route
        x = _randn(gen, 2, 4 * 8 * 8, 768)
        reset_launches()
        got, _ = blk(x, thw)
        ran = {name: WRAPPERS[name].launches for name in ("attention", "mlp_tail", "decoder_block")}
        with plain_twins():
            want, _ = blk(x, thw)
        tag = "decoder block 768 -> 384, 3 heads of 256 (route composite)"
        rows.append({"case": tag, "launches": ran})
        err = _max_err(got, want)
        bar = bf16_bar("decoder_block", want)
        log(f"  {tag}: launches {ran}, block vs plain max|Δ| {err:.3g} (bar {bar:.3g})")
        if not (err <= bar and ran["attention"] == 1 and ran["mlp_tail"] == 1
                and ran["decoder_block"] == 0):
            failures.append(f"{tag}: max|Δ| {err} bar {bar}, launches {ran}")
        # B4 at a width without a split instance: the first design's body
        args = b4_inputs((4, 16, 16), 96, 192, 1, gen)
        reset_launches()
        got = kb.fused_pool_block(*args)
        want = kb.fused_pool_block_plain(*args)
        check("B4 96 -> 192, 1 head (first design)", "pool_block", got, want,
              bf16_bar("pool_block", want))
    torch.cuda.empty_cache()
    assert not failures, "widths:\n" + "\n".join(failures)
    return {"cases": rows}


def make_inputs(rng: np.random.Generator, n: int, spec):
    t, s = spec.num_frames, spec.crop_size
    video = rng.standard_normal((n, t, s, s, 3), dtype=np.float32)
    audio = rng.standard_normal((n, t, s, s, 1), dtype=np.float32)
    return video, audio


def make_train_batch(rng: np.random.Generator, n: int, spec) -> dict:
    """A training batch on the card: video, audio and per-frame normalised
    heatmap labels (B, T, crop/4, crop/4)."""
    video, audio = make_inputs(rng, n, spec)
    hw = spec.crop_size // 4
    hm = rng.uniform(0.0, 1.0, (n, spec.num_frames, hw, hw)).astype(np.float32)
    hm /= hm.sum(axis=(2, 3), keepdims=True)
    return {name: torch.from_numpy(a).cuda()
            for name, a in (("video", video), ("audio", audio), ("labels_hm", hm))}


def timed_steps(step, state, batch, gen, n: int) -> list:
    """n training steps, each timed with CUDA events: [(ms, stats as floats)]."""
    out = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        stats, _ = step(state, batch, gen)
        end.record()
        torch.cuda.synchronize()
        out.append((start.elapsed_time(end), {k: float(v) for k, v in stats.items()}))
    return out


def train_path(rng: np.random.Generator) -> dict:
    """Phase 5: the flagship's training steps through the kernels."""
    cfg = flagship_train_cfg()
    spec = build_spec(cfg)
    bsz = cfg.TRAIN.BATCH_SIZE
    state = train_lib.create_train_state(cfg, spec, torch.Generator().manual_seed(SEED),
                                         device="cuda")
    n_params = sum(p.numel() for p in state.model.parameters())
    batch = make_train_batch(rng, bsz, spec)
    step = train_lib.make_train_step(cfg, spec, steps_per_epoch=STEPS_PER_EPOCH)
    gen = torch.Generator().manual_seed(SEED + 1)

    t0 = time.perf_counter()
    step(state, batch, gen)
    torch.cuda.synchronize()
    log(f"phase train warm-up: flagship {n_params / 1e6:.1f}M fp32 master params, bf16 compute, "
        f"batch {bsz}, {time.perf_counter() - t0:.2f} s")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    steps = timed_steps(step, state, batch, gen, TRAIN_STEPS)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {name: WRAPPERS[name].launches for name in COUNTED}
    for i, (ms, st) in enumerate(steps):
        log(f"  step {i}: {ms:.2f} ms, loss {st['loss']:.6g} (kldiv {st['kldiv_loss']:.6g}, "
            f"egonce {st['egonce_loss']:.6g}), grad_norm {st['grad_norm']:.6g}, lr {st['lr']:.6g}")
        assert all(np.isfinite(v) for v in st.values()), st
    step_ms = float(np.median([ms for ms, _ in steps]))
    log(f"phase train: {TRAIN_STEPS} steps, median {step_ms:.2f} ms/step = {bsz * 1e3 / step_ms:.2f} "
        f"train clips/s, peak memory {peak_gib:.2f} GiB ({CARD}); launches {launches}")
    for name, per in PER_STEP.items():
        need = per * TRAIN_STEPS
        assert launches[name] == need, f"train {name}: {launches[name]} launches, expected {need}"

    profile = profile_forward(lambda: step(state, batch, gen), step_ms, log=log)
    # the plain attention twin in place of K1 + B8, in turns with the kernels
    kern, plain = [ms for ms, _ in steps], []
    for _ in range(3):
        with train_twins(("attention_train",)):
            plain += [ms for ms, _ in timed_steps(step, state, batch, gen, 4)[1:]]
        kern += [ms for ms, _ in timed_steps(step, state, batch, gen, 3)]
    plain_ms, kern_ms = float(np.median(plain)), float(np.median(kern))
    log(f"phase train plain attention: median {plain_ms:.2f} ms/step with the plain attention "
        f"twin ({', '.join(f'{x:.1f}' for x in plain)}) vs {kern_ms:.2f} through K1 + B8 "
        f"({', '.join(f'{x:.1f}' for x in kern)}), in turns ({CARD})")

    # one more step records the inputs of every B7 forward, B7 backward and B8 call
    calls = {name: {} for name in ("mlp_tail_train", "mlp_tail_train_bwd", "attention_bwd")}
    with recording(calls):
        step(state, batch, gen)
    torch.cuda.synchronize()
    log("phase train record: distinct shapes "
        + ", ".join(f"{n} {len(s)} ({sum(c for c, _, _ in s.values())} calls)"
                    for n, s in calls.items()))
    for name, per in (("mlp_tail_train", "mlp_tail_train"), ("mlp_tail_train_bwd", "mlp_tail_train"),
                      ("attention_bwd", "attention_bwd")):
        got = sum(c for c, _, _ in calls[name].values())
        assert got == PER_STEP[per], f"recorded {name}: {got} calls, expected {PER_STEP[per]}"
    del state, batch
    torch.cuda.empty_cache()
    return {"calls": calls, "launches": launches, "step_ms": step_ms, "steps": steps,
            "clips_per_s": bsz * 1e3 / step_ms, "peak_gib": peak_gib, "profile": profile,
            "plain_attention_step_ms": plain_ms, "kernel_step_ms_in_turns": kern_ms,
            "plain_attention_steps_ms": plain, "kernel_steps_ms_in_turns": kern,
            "params_m": n_params / 1e6}


def _tail_bwd_autograd(x, ln_w, ln_b, w1, b1, w2, b2, wp, bp, dp, hid, g):
    """Autograd of B7's plain version: the gradients of x and each weight
    (hid is recomputed, not read)."""
    leaves = [None if t is None else t.detach().requires_grad_()
              for t in (x, ln_w, ln_b, w1, b1, w2, b2, wp, bp)]
    with torch.enable_grad():
        out = kb.fused_mlp_tail_train_plain(*leaves, dp)[0]
    return torch.autograd.grad(out, [t for t in leaves if t is not None], g)


def _tail_bwd_fp32(args):
    """B7 backward's recorded inputs in fp32, the hidden from the fp32 forward."""
    args32 = _to_fp32(args)
    return args32[:10] + (kb.fused_mlp_tail_train_plain(*args32[:10])[1],) + args32[11:]


def check_train_kernels(calls: dict) -> dict:
    """Phase 6a: B7, B8 and B7's backward against their plain versions at
    every shape the training step recorded, in bf16 as recorded and in fp32."""
    report = {name: {"shapes": [], "max_abs_err": 0.0, "max_abs_err_fp32": 0.0}
              for name in TRAIN_KERNELS}
    report["mlp_tail_train_bwd"] = {"shapes": [], "max_rel_err": 0.0, "max_rel_err_fp32": 0.0}
    failures = []

    def bar(name, ref, dtype):
        scale = float(ref.float().abs().max())
        if name == "attention_bwd":
            return B8_BAR[dtype] * scale
        if dtype == torch.float32:
            return FP32_ATOL["mlp_tail"] + FP32_RTOL["mlp_tail"] * scale
        return bf16_bar(name, ref)

    for name, k in TRAIN_KERNELS.items():
        kern, plain = WRAPPERS[name], k["plain"]
        for sig, (count, args, _) in calls[name].items():
            row = {"signature": repr(sig), "launches_per_step": count}
            for tag, a in (("", args), ("_fp32", _to_fp32(args))):
                with torch.no_grad():
                    got = kern(*a)
                    torch.cuda.synchronize()
                    ref = plain(*a)
                dtype = a[0].dtype
                errs = [_max_err(x, y) for x, y in zip(got, ref)]
                bars = [bar(name, y, dtype) for y in ref]
                for i, (e, b, x) in enumerate(zip(errs, bars, got)):
                    if not (e <= b and bool(torch.isfinite(x.float()).all())):
                        failures.append(f"{name}{tag} {sig} output {i}: max|Δ| {e} > {b}")
                row[f"max_abs_err{tag}"], row[f"bar{tag}"] = errs, bars
                report[name][f"max_abs_err{tag}"] = max(report[name][f"max_abs_err{tag}"], *errs)
                if name == "attention_bwd":
                    # no atomics: a second run gives the same bits
                    with torch.no_grad():
                        again = kern(*a)
                    row[f"bit_equal{tag}"] = all(torch.equal(x, y) for x, y in zip(got, again))
                    if not row[f"bit_equal{tag}"]:
                        failures.append(f"{name}{tag} {sig}: two runs differ")
                    del again
                del got, ref
            nbytes, flops = k["cost"](*args)
            with torch.no_grad():
                row.update(ms=time_ms(lambda: kern(*args)), plain_ms=time_ms(lambda: plain(*args)),
                           device_ms=device_ms(lambda: kern(*args)))
            lib = k["library"](*args) if k["library"] is not None else None
            row["library_ms"] = time_ms(lib) if lib is not None else None
            # the library call's device time (SDPA's backward at B8's shapes)
            row["library_device_ms"] = device_ms(lib) if lib is not None else None
            if k.get("yardstick") is not None:
                run = k["yardstick"](*args)
                row.update(cublas_ms=time_ms(run), cublas_device_ms=device_ms(run))
            del lib
            row.update(bytes=nbytes, flops=flops, bytes_ms=nbytes / PEAK_BYTES_S * 1e3,
                       ops_ms=flops / PEAK_BF16_FLOPS * 1e3)
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            log(f"  {name} {sig[0]} x{count}: {row['ms']:.4f} ms, device {row['device_ms']:.4f} "
                f"(plain {row['plain_ms']:.4f}, library {row['library_ms']} / device "
                f"{row['library_device_ms']}, bound {row['bound_ms']:.4f} = bytes "
                f"{row['bytes_ms']:.4f} / ops {row['ops_ms']:.4f}"
                + (f"; cuBLAS products {row['cublas_ms']:.4f} / device "
                   f"{row['cublas_device_ms']:.4f}" if "cublas_ms" in row else "")
                + f") max|Δ| bf16 {max(row['max_abs_err']):.3g} fp32 "
                f"{max(row['max_abs_err_fp32']):.3g} ({CARD})")
            report[name]["shapes"].append(row)

    bwd = report["mlp_tail_train_bwd"]
    for sig, (count, args, _) in calls["mlp_tail_train_bwd"].items():
        row = {"signature": repr(sig), "calls_per_step": count}
        for tag, a in (("", args), ("_fp32", _tail_bwd_fp32(args))):
            with torch.no_grad():
                got = [t for t in WRAPPERS["mlp_tail_train_bwd"](*a) if t is not None]
            ref = _tail_bwd_autograd(*a)
            errs = [rel_err(x, y) for x, y in zip(got, ref)]
            limits = [(B7_BWD_VECTOR_BAR if y.dim() == 1 else B7_BWD_BAR)[a[0].dtype] for y in ref]
            if not (len(got) == len(ref) and all(e <= b for e, b in zip(errs, limits))):
                failures.append(f"mlp_tail_train_bwd{tag} {sig[0]}: relative errors {errs} "
                                f"(bars {limits})")
            row[f"rel_err{tag}"] = errs
            bwd[f"max_rel_err{tag}"] = max(bwd[f"max_rel_err{tag}"], *errs)
        with torch.no_grad():
            row["ms"] = time_ms(lambda: WRAPPERS["mlp_tail_train_bwd"](*args))
        row["autograd_plain_ms"] = time_ms(lambda: _tail_bwd_autograd(*args))
        log(f"  mlp_tail_train_bwd {sig[0]} x{count}: {row['ms']:.4f} ms (autograd of the plain "
            f"version {row['autograd_plain_ms']:.4f}) rel err bf16 {max(row['rel_err']):.3g} "
            f"fp32 {max(row['rel_err_fp32']):.3g} ({CARD})")
        bwd["shapes"].append(row)
    torch.cuda.empty_cache()
    assert not failures, "training kernels vs plain:\n" + "\n".join(failures)
    return report


def whole_step_check(rng: np.random.Generator) -> dict:
    """Phase 6b: one fp32 step at batch 2 (TF32 off) through the kernels and
    through the plain twins, from the same weights, masks and batch: the
    loss and every parameter's gradient."""
    cfg = flagship_train_cfg()
    cfg.TRAIN.MIXED_PRECISION = False
    cfg.TRAIN.BATCH_SIZE = 2
    spec = build_spec(cfg)
    model = CSTS(spec)
    init_params(model, torch.Generator().manual_seed(SEED))
    model = model.cuda().train()
    batch = make_train_batch(rng, 2, spec)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        drop = sample_drop_masks(spec, 2, torch.Generator().manual_seed(SEED + 2), "cuda")
        loss, _, _ = train_lib.forward_loss(cfg, model, batch, drop)
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().clone() if p.grad is not None
                             else torch.zeros_like(p) for n, p in model.named_parameters()}

    reset_launches()
    loss_k, grads_k = loss_and_grads()
    ran = {name: WRAPPERS[name].launches for name in ("attention", "mlp_tail_train",
                                                      "attention_bwd", "t2_upsample")}
    assert all(ran.values()), f"the fp32 step skipped a kernel: {ran}"
    with train_twins():
        loss_p, grads_p = loss_and_grads()
    norm = lambda t: float(torch.linalg.vector_norm(t.float()))  # noqa: E731
    total = float(np.sqrt(sum(norm(g) ** 2 for g in grads_p.values())))
    floor = STEP_GRAD_FLOOR * total
    # each gradient's error as a share of its bar (fails above 1)
    share = {n: norm(grads_k[n] - grads_p[n]) / (STEP_GRAD_RTOL * norm(grads_p[n]) + floor)
             for n in grads_p}
    rel = {n: rel_err(grads_k[n], grads_p[n]) for n in grads_p if norm(grads_p[n]) > floor}
    worst = sorted(share.items(), key=lambda kv: -kv[1])[:5]
    worst_rel = max(rel.values())
    dloss = abs(loss_k - loss_p) / abs(loss_p)
    log(f"phase train fp32 step: loss {loss_k:.8g} vs plain {loss_p:.8g} (relative {dloss:.3g}); "
        f"{len(share)} gradients (whole norm {total:.4g}), worst relative norm {worst_rel:.3g} "
        f"among the {len(rel)} above the floor; worst shares of the bar "
        + ", ".join(f"{n} {e:.3g}" for n, e in worst))
    assert dloss <= STEP_LOSS_RTOL, (loss_k, loss_p)
    assert worst[0][1] <= 1.0, worst
    del model, grads_k, grads_p
    torch.cuda.empty_cache()
    return {"loss": loss_k, "loss_plain": loss_p, "loss_rel_err": dloss,
            "grad_norm": total, "grad_rel_err_max": worst_rel, "bar_share_worst": worst}


def hw2_phase(pred, v, a) -> dict:
    """Phase 4b: B9a behind ab_flags' hw2_skip switch, under the serving
    predictor at batch 8: launches with the switch on and off, B9a against
    its plain version at d2's and d3's shapes, the forward timed on and off
    in turns, and the two forwards' outputs compared. The switch is restored
    on the way out (``ab_flags.flags``)."""
    counts = {}
    for conf in ("hw2_skip", "base"):
        with ab_flags.flags(conf), torch.inference_mode():
            reset_launches()
            pred.forward(v, a)
            torch.cuda.synchronize()
            counts[conf] = {name: WRAPPERS[name].launches for name in PER_FORWARD}
    log(f"phase hw2 launches: switch on {counts['hw2_skip']}, off {counts['base']}")
    assert counts["hw2_skip"]["hw2_upsample"] == HW2_PER_FORWARD, counts
    for conf in counts:
        for name, per in PER_FORWARD.items():
            if name != "hw2_upsample":
                assert counts[conf][name] == per, (conf, name, counts[conf][name], per)
    assert counts["base"]["hw2_upsample"] == 0, counts

    calls = {"hw2_upsample": {}}
    with ab_flags.flags("hw2_skip"), recording(calls), torch.inference_mode():
        pred.forward(v, a)
    torch.cuda.synchronize()
    with torch.inference_mode():
        rows = check_kernels({8: calls}, B9_KERNELS)["hw2_upsample"]["shapes"]
    assert sum(r["launches_per_forward"] for r in rows) == HW2_PER_FORWARD, rows

    # the forward with the switch on and off, in turns
    turns = {"hw2_skip": [], "base": []}
    with torch.inference_mode():
        for conf in ("base", "hw2_skip", "hw2_skip", "base") * 3:
            with ab_flags.flags(conf):
                turns[conf].append(time_ms(lambda: pred.forward(v, a), target_s=0.3))
        logits = {}
        for conf in ("hw2_skip", "base"):
            with ab_flags.flags(conf):
                logits[conf] = pred.model(v, a).float()
        busy = {}
        for conf in ("hw2_skip", "base"):
            with ab_flags.flags(conf):
                busy[conf] = device_trace(lambda: pred.forward(v, a))[1]
    on, off = logits["hw2_skip"], logits["base"]
    dlogit = float((on - off).abs().max())
    dsm = float((frame_softmax(on) - frame_softmax(off)).abs().max())
    flat = off.reshape(*off.shape[:2], -1)
    top2 = flat.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * dlogit
    agree = (flat.argmax(-1) == on.reshape(flat.shape).argmax(-1))[decided]
    on_ms, off_ms = float(np.median(turns["hw2_skip"])), float(np.median(turns["base"]))
    log(f"phase hw2 forward: batch 8 bf16 with hw2_skip {on_ms:.3f} ms vs off {off_ms:.3f} ms "
        f"(turns on {', '.join(f'{x:.3f}' for x in turns['hw2_skip'])}; off "
        f"{', '.join(f'{x:.3f}' for x in turns['base'])}), ratio off/on {off_ms / on_ms:.4f}; "
        f"device busy on {busy['hw2_skip']:.3f} ms vs off {busy['base']:.3f} ms; "
        f"logits max|Δ| {dlogit:.4g}, per-frame softmax max|Δ| {dsm:.3g}, argmax agrees on "
        f"{int(agree.sum())}/{int(decided.sum())} decided frames ({CARD})")
    assert dsm < 0.02, dsm
    assert bool(agree.all()), "hw2_skip changes the argmax of a decided frame"
    return {"launches": counts["hw2_skip"]["hw2_upsample"], "launches_on": counts["hw2_skip"],
            "launches_off": counts["base"], "shapes": rows, "forward_on_ms": on_ms,
            "forward_off_ms": off_ms, "turns_ms": turns, "forward_on_device_ms": busy["hw2_skip"],
            "forward_off_device_ms": busy["base"], "logits_max_abs_diff": dlogit,
            "softmax_max_abs_diff": dsm}


def blocks_phase() -> dict:
    """Phase 4c: ab_block's stacks at batch 8. Each stack runs once through
    the whole-block kernel with the counters set to 0 just before and read
    just after; at 3-8 heads (B9b/B9c) the kernel is held against its plain
    version at each shape and timed; every stack is timed through the kernel
    and through the K1+K2 route (``ab_block.run``)."""
    launches, rows, per_stack = 0, [], {}
    for row in ab_block.SHAPES:
        name, dim, dim_out, heads, thw, _, reps = row
        block, x = ab_block.make_stack(row, BLOCK_BATCH, "cuda")
        _, fused = ab_block.stack_fns(block, thw, reps)
        reset_launches()
        fused(x)
        torch.cuda.synchronize()
        n = WRAPPERS["block_multihead"].launches
        assert n == reps, (name, n, reps)
        per_stack[name.strip()] = n
        if heads > 2:
            launches += n
            calls = {"block_multihead": {}}
            with recording(calls):
                fused(x)
            torch.cuda.synchronize()
            with torch.inference_mode():
                rows += check_kernels({BLOCK_BATCH: calls}, B9_KERNELS)["block_multihead"]["shapes"]
        del block, x
    log(f"phase blocks launches per stack: {per_stack}")
    stacks = ab_block.run(ab_block.SHAPES, BLOCK_BATCH, 20, "cuda",
                         log=lambda s: log("  " + s), rounds=3)
    multi = [s for s in stacks if s["heads"] > 2]
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_per_stack": per_stack, "shapes": rows,
            "stacks": stacks, "block_ms": sum(s["block_ms"] for s in multi),
            "composite_ms": sum(s["composite_ms"] for s in multi),
            "block_device_ms": sum(s["block_device_ms"] for s in multi),
            "composite_device_ms": sum(s["composite_device_ms"] for s in multi)}


# the eval phase: a synthetic test split in the reference's layout (npy
# backend), short side 256 so the flagship's test transform is a centre crop.
# The split lists the 20 clips 15 times: 300 rows, 38 batches, so that the
# loop runs on after the 16 batches the 8 workers fetch while they start
# (prefetch 2 each) and its rate after the first batch is the loop's, not
# the workers' start-up.
EVAL_CLIPS = 20
EVAL_REPEATS = 15
EVAL_ROWS = EVAL_CLIPS * EVAL_REPEATS
EVAL_RES = (256, 320)
EVAL_BATCH = 8  # TEST.BATCH_SIZE: 300 rows leave a final batch of 4
EVAL_TOL = 1e-6  # the loop's StreamingF1 against the float64 twin


def _bf16_round(x) -> np.ndarray:
    """float32 -> the nearest bf16 (ties to even), as float64."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def stream_twin(batches, dataset: str) -> dict:
    """A float64 numpy twin of ``StreamingF1`` over bf16 rescaled heatmaps:
    the threshold grid and the AUC's ranks rounded to bf16 where the port
    (and the JAX package) holds them in the predictions' dtype, every sum
    in float64."""
    from csts_torch.eval.metrics import fixation_index, thresholds_for

    th = _bf16_round(np.asarray(thresholds_for(dataset), np.float64))
    fix = fixation_index(dataset)
    r_sum = np.zeros(len(th))
    p_sum = np.zeros(len(th))
    count = auc_sum = auc_count = 0.0
    for preds, labels_hm, labels in batches:
        b, t, h, w = preds.shape
        pos = labels_hm > 0.001
        fg_l = pos.sum(axis=(2, 3))
        over = preds[None] > th[:, None, None, None, None]
        tp = (over & pos[None]).sum(axis=(3, 4))
        fg_p = over.sum(axis=(3, 4))
        mask = labels[:, :, 2] == fix
        r_sum += (tp / (fg_l[None] + 1e-6) * mask[None]).sum(axis=(1, 2))
        p_sum += (tp / (fg_p + 1e-6) * mask[None]).sum(axis=(1, 2))
        count += mask.sum()
        ranks = _bf16_round(_bf16_round(np.arange(h * w)) + 1.0)
        for i in range(b):
            for f in range(t):
                flat, pf = preds[i, f].reshape(-1), pos[i, f].reshape(-1)
                n_pos = pf.sum()
                if not (mask[i, f] and n_pos):
                    continue
                rank = np.empty(h * w)
                rank[np.argsort(flat, kind="stable")] = ranks
                auc_sum += (rank[pf].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * (h * w - n_pos))
                auc_count += 1
    recall, precision = r_sum / count, p_sum / count
    f1 = 2 * recall * precision / (recall + precision + 1e-6)
    i = int(np.argmax(f1))
    return {"f1": float(f1[i]), "recall": float(recall[i]), "precision": float(precision[i]),
            "threshold": float(thresholds_for(dataset)[i]), "auc": float(auc_sum / auc_count)}


def eval_phase(rng: np.random.Generator) -> dict:
    """The eval entry point (``csts_torch.eval.tester.test``) at flagship width
    on a synthetic test split written to a temporary directory: loader
    (spawned workers, pinned batches, the side-stream prefetcher), the bf16
    forward through the kernels, the streaming metrics, the results npz.
    Counters set to 0 before and read after; the loop's logits and heatmaps
    held against the same batches through the fp32 plain twins (and the
    check shown to reject weights from another seed), its metrics against
    ``stream_twin`` on the same predictions."""
    import tempfile

    from csts_torch.data import loader as loader_lib
    from csts_torch.data.synthetic import write_dataset
    from csts_torch.eval import metrics as tmetrics
    from csts_torch.eval import tester
    from csts_torch.tools import check_line, heatmap_check

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        prefix, splits = write_dataset(root, "ego4d", num_clips=EVAL_CLIPS, frames=150,
                                       res=EVAL_RES, fps=30, seed=int(rng.integers(1 << 30)))
        test_csv = os.path.join(splits, "test_ego4d_gaze.csv")
        with open(test_csv) as f:
            clips = f.read().splitlines()
        with open(test_csv, "w") as f:
            f.write("\n".join(clips * EVAL_REPEATS) + "\n")
        write_s = time.perf_counter() - t0
        cfg = flagship_cfg()
        cfg.TRAIN.MIXED_PRECISION = True
        spec = build_spec(cfg)
        ref_model = CSTS(dataclasses.replace(spec, dtype="float32"))
        init_params(ref_model, torch.Generator().manual_seed(SEED + 1))
        weights = os.path.join(root, "weights.pyth")
        torch.save({"model_state": ref_model.state_dict()}, weights)
        cfg.DATA.PATH_PREFIX, cfg.DATA.PATH_TO_DATA_DIR = prefix, splits
        cfg.DATA.DECODING_BACKEND = "npy"
        cfg.TRAIN.ENABLE = False
        cfg.TEST.DATASET = "ego4d_av_gaze_forecast"
        cfg.TEST.BATCH_SIZE = EVAL_BATCH
        cfg.TEST.NUM_ENSEMBLE_VIEWS = cfg.TEST.NUM_SPATIAL_CROPS = 1
        cfg.TEST.CHECKPOINT_FILE_PATH = weights
        cfg.TEST.SAVE_RESULTS_PATH = "results.npz"
        cfg.OUTPUT_DIR = os.path.join(root, "out")
        cfg.LOG_PERIOD = 1

        # what the loop did: its batches, logits and heatmaps, the consumer's
        # wait on the loader, each forward's span on the card (CUDA events)
        seen = {"batches": [], "waits": [], "first": None, "last": None, "events": []}
        make_eval_step, next_batch = train_lib.make_eval_step, loader_lib.DevicePrefetcher.__next__

        def timed_next(self):
            t = time.perf_counter()
            if seen["first"] is None:
                seen["first"] = t
            try:
                return next_batch(self)
            finally:
                seen["last"] = time.perf_counter()
                seen["waits"].append(seen["last"] - t)

        def recording_step(cfg_, spec_):
            step = make_eval_step(cfg_, spec_)

            def run(model, batch):
                logits = []
                hook = model.register_forward_hook(lambda m, i, o: logits.append(o))
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                try:
                    start.record()
                    out = step(model, batch)
                    end.record()
                finally:
                    hook.remove()
                seen["events"].append((start, end))
                seen["batches"].append({k: v.clone() for k, v in batch.items()}
                                       | {"probs": out, "logits": logits[0]})
                return out
            return run

        reset_launches()
        t_test = time.perf_counter()
        try:
            train_lib.make_eval_step = recording_step
            loader_lib.DevicePrefetcher.__next__ = timed_next
            stats = tester.test(cfg)
        finally:
            train_lib.make_eval_step = make_eval_step
            loader_lib.DevicePrefetcher.__next__ = next_batch
        test_s = time.perf_counter() - t_test
        launches = {name: WRAPPERS[name].launches for name in PER_FORWARD}
        res = np.load(os.path.join(cfg.OUTPUT_DIR, "results.npz"))
        result_rows = [int(i) for i in res["index"]]
        # the host's cost a clip alone: the split read and collated in this
        # process, no workers, no card
        cfg.DATA_LOADER.NUM_WORKERS = 0
        t_read = time.perf_counter()
        decoded = sum(len(b["index"]) for b in loader_lib.construct_loader(cfg, "test"))
        decode_s = time.perf_counter() - t_read

    batches = seen["batches"]
    rows = sum(len(b["index"]) for b in batches)
    forwards = [s.elapsed_time(e) for s, e in seen["events"]]
    # start-up: test() called until the first batch is in hand (the model
    # built and loaded while the workers start, then the first batch's
    # wait); the loop: from there to its end, over the batches after the first
    first_in_hand = seen["first"] + seen["waits"][0]
    loop_s = seen["last"] - first_in_hand
    loop_rows = rows - len(batches[0]["index"])
    wait_s, forward_ms = sum(seen["waits"][1:]), sum(forwards[1:])
    out = {"write_s": write_s, "test_s": test_s, "startup_s": first_in_hand - t_test,
           "setup_s": seen["first"] - t_test, "first_batch_wait_s": seen["waits"][0],
           "loop_s": loop_s, "loop_rows": loop_rows, "rows": rows, "batches": len(batches),
           "clips_per_s": loop_rows / loop_s, "test_clips_per_s": rows / test_s,
           "loader_wait_s": wait_s, "loader_wait_share": wait_s / loop_s,
           "forward_ms": forward_ms, "forward_share": forward_ms / 1e3 / loop_s,
           "waits_s": seen["waits"], "forwards_ms": forwards,
           "decode_ms_per_clip": decode_s * 1e3 / decoded, "launches": launches, "stats": stats}
    log(f"phase eval: {rows} rows in {len(batches)} batches; test() {test_s:.2f} s "
        f"({out['test_clips_per_s']:.2f} clips/s, start-up included); start-up "
        f"{out['startup_s']:.2f} s to the first batch in hand (model built and loaded "
        f"{out['setup_s']:.2f} s while the loader's workers start, then the first batch waited "
        f"{out['first_batch_wait_s']:.2f} s); loop after the first batch {loop_s:.3f} s for "
        f"{loop_rows} rows = {out['clips_per_s']:.2f} clips/s loader included, consumer waited "
        f"on the loader {wait_s:.3f} s (share {out['loader_wait_share']:.3f}), forwards "
        f"{forward_ms:.2f} ms on the card (share {out['forward_share']:.3f}), first forward "
        f"{forwards[0]:.2f} ms; dataset written in {write_s:.2f} s; waits "
        + ", ".join(f"{w * 1e3:.1f}" for w in seen["waits"]) + " ms, forwards "
        + ", ".join(f"{f:.2f}" for f in forwards)
        + f" ms; one process reads and collates a clip in {out['decode_ms_per_clip']:.1f} ms "
        f"({1e3 / out['decode_ms_per_clip']:.1f} clips/s); launches {launches} ({CARD})")
    assert rows == EVAL_ROWS and result_rows == list(range(EVAL_ROWS)), (rows, result_rows)
    assert sorted(int(i) for b in batches for i in b["index"]) == list(range(EVAL_ROWS))
    for name, per in PER_FORWARD.items():
        assert launches[name] == per * len(batches), (name, launches[name], per, len(batches))

    # the loop's logits and heatmaps against the same batches through the
    # fp32 plain twins; then a planted fault, the first batch against
    # weights from another seed (what a tester that scored the wrong
    # weights would give), which the same check must reject
    ref_model = ref_model.cuda().eval()
    worst = None
    twin_in = []
    with plain_twins(), torch.inference_mode():
        for b in batches:
            chk = heatmap_check(b["logits"], ref_model(b["video"], b["audio"]), probs=b["probs"])
            if worst is None:
                worst = chk
            else:
                for k in ("logits_max_abs_diff", "softmax_max_abs_diff"):
                    worst[k] = max(worst[k], chk[k])
                worst["logits_bar"] = min(worst["logits_bar"], chk["logits_bar"])
                for k in ("argmax_off_on_decided", "decided_frames", "frames"):
                    worst[k] += chk[k]
                worst["ok"] = worst["ok"] and chk["ok"]
            rescaled = tmetrics.minmax_rescale(b["probs"])
            twin_in.append((rescaled.float().cpu().numpy().astype(np.float64),
                            b["labels_hm"].cpu().numpy().astype(np.float64),
                            b["labels"].cpu().numpy().astype(np.float64)))
        ref_model.cpu()
        wrong = CSTS(dataclasses.replace(spec, dtype="float32"))
        init_params(wrong, torch.Generator().manual_seed(SEED + 2))
        wrong = wrong.cuda().eval()
        b = batches[0]
        planted = heatmap_check(b["logits"], wrong(b["video"], b["audio"]), probs=b["probs"])
        del wrong
    twin = stream_twin(twin_in, cfg.TEST.DATASET)
    out.update(reference=worst, planted_fault=planted, twin=twin)
    log(f"phase eval reference: {check_line(worst)}, against the fp32 plain twins over all "
        f"{len(batches)} batches (worst batch; bar the smallest)")
    log(f"phase eval planted fault (the first batch against weights from another seed): "
        f"{check_line(planted)}; rejected: {not planted['ok']}")
    log("phase eval metrics: loop " + ", ".join(f"{k} {stats[k]:.8g}" for k in twin)
        + "; float64 twin " + ", ".join(f"{k} {v:.8g}" for k, v in twin.items()))
    assert worst["ok"], worst
    assert not planted["ok"], planted
    assert twin["threshold"] == stats["threshold"], (twin, stats)
    for k in ("f1", "recall", "precision", "auc"):
        assert abs(twin[k] - stats[k]) <= EVAL_TOL, (k, twin[k], stats[k])
    del batches, seen
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------------------
# the trainer phase: run_net's train mode from the shipped yaml on a synthetic
# split written to a temporary directory; the yaml's fine-tune recipe from
# seeded .pyth files; a preemption drill; the npz's JAX layout; beside it the
# raw step with ACT_CHECKPOINT on and off and with accum_steps 2 and 1
# ----------------------------------------------------------------------------------

YAML = os.path.join(ROOT, "configs", "Ego4D", "CSTS_Ego4D_Gaze_Forecast.yaml")
TRAINER_CLIPS = 12
TRAINER_TRAIN_ROWS = 48  # the 12 clips listed 4 times: 6 iterations of 8 an epoch
TRAINER_VAL_ROWS = 16    # val and test: 2 batches of 8
TRAINER_EPOCHS = 2
PREEMPT_AFTER = 3        # the drill's SIGTERM after 3 of the first epoch's 6 iterations
PYTH_CROP = 224          # the video .pyth's crop: its spatial position embedding is resampled
# 8 loader workers (the yaml's) for the run whose loop is measured; 2 for the
# drill's runs, whose loop is not: each worker start costs the fork server's
# imports, and the drill runs train() three more times
DRILL_WORKERS = 2
ACCUM_BATCH = 16         # accum_steps 2 of 8 against one pass of 16


def _trainer_split(root: str, seed: int):
    """The split: TRAINER_CLIPS clips (150 frames, 256x320); the train list
    holds them TRAINER_TRAIN_ROWS // TRAINER_CLIPS times, the test list
    (which val reads too) TRAINER_VAL_ROWS rows."""
    from csts_torch.data.synthetic import write_dataset

    prefix, splits = write_dataset(root, "ego4d", num_clips=TRAINER_CLIPS, frames=150,
                                   res=EVAL_RES, fps=30, seed=seed)
    with open(os.path.join(splits, "train_ego4d_gaze.csv")) as f:
        clips = f.read().splitlines()
    rows = {"train_ego4d_gaze.csv": clips * (TRAINER_TRAIN_ROWS // TRAINER_CLIPS),
            "test_ego4d_gaze.csv": (clips * 2)[:TRAINER_VAL_ROWS]}
    for name, lines in rows.items():
        with open(os.path.join(splits, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    return prefix, splits


def _trainer_pyths(root: str):
    """The yaml's init recipe as two seeded reference checkpoints: a
    video-only MViT at crop PYTH_CROP (its spatial position embedding has
    another token count, so the load interpolates it) and an audio-pretrained
    MViT under plain ``blocks.*`` / ``patch_embed.*`` / ``pos_embed_*``
    names (the load remaps them to the audio branch)."""
    cfg = flagship_cfg()
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = PYTH_CROP
    model = CSTS(build_spec(cfg))
    init_params(model, torch.Generator().manual_seed(SEED + 3))
    sd = model.state_dict()
    video = {k: v for k, v in sd.items() if not k.endswith("_audio")
             and k.startswith(("patch_embed.", "pos_embed_", "blocks."))}
    audio = {}
    for k, v in sd.items():
        if k.startswith("blocks_audio."):
            audio["blocks." + k[len("blocks_audio."):]] = v
        elif k.startswith("patch_embed_audio."):
            audio["patch_embed." + k[len("patch_embed_audio."):]] = v
        elif k in ("pos_embed_spatial_audio", "pos_embed_temporal_audio"):
            audio[k[:-len("_audio")]] = v
    paths = os.path.join(root, "k400_video_224.pyth"), os.path.join(root, "audio_mvit.pyth")
    for path, part in zip(paths, (video, audio)):
        torch.save({"model_state": part, "epoch": 0}, path)
    return paths, tuple(sd["pos_embed_spatial"].shape)


def _run_net_args(split, pyths, out: str, workers: int, test: bool) -> list:
    """run_net's arguments: the yaml and what this phase sets over it. The
    run that tests saves its final epoch; the drill's runs save only the
    preemption's npz (their final states are compared in memory)."""
    prefix, splits = split
    return ["--cfg", YAML, "DATA.PATH_PREFIX", prefix, "DATA.PATH_TO_DATA_DIR", splits,
            "DATA.DECODING_BACKEND", "npy", "TRAIN.MIXED_PRECISION", "True",
            "SOLVER.MAX_EPOCH", str(TRAINER_EPOCHS), "TRAIN.CHECKPOINT_PERIOD",
            str(TRAINER_EPOCHS if test else TRAINER_EPOCHS + 1),
            "TRAIN.CHECKPOINT_FILE_PATH", pyths[0],
            "TRAIN.AUDIO_CHECKPOINT_FILE_PATH", pyths[1], "TEST.ENABLE", str(test),
            "TEST.BATCH_SIZE", "8", "DATA_LOADER.NUM_WORKERS", str(workers),
            "LOG_PERIOD", "1", "OUTPUT_DIR", out]


def _groups(leaves: list, p: int) -> dict:
    """A TrainState's leaves (3P+4, no EMA) as its params, moments and scalars."""
    return {"params": leaves[:p], "mu": leaves[p + 3:2 * p + 3],
            "nu": leaves[2 * p + 3:3 * p + 3],
            "scalars": [leaves[p], leaves[p + 1], leaves[p + 2], leaves[3 * p + 3]]}


def _diff(a: dict, b: dict) -> dict:
    """Largest |Δ| and the root mean square of Δ of each group of two
    TrainStates."""
    out = {}
    for g in a:
        d = [np.asarray(x, np.float64) - y for x, y in zip(a[g], b[g])]
        n = sum(x.size for x in d)
        out[g] = {"max": max(float(np.abs(x).max()) for x in d),
                  "rms": float(np.sqrt(sum(float(np.square(x).sum()) for x in d) / n))}
    return out


def _npz_shapes(path: str) -> list:
    """The leaves' shapes of an npz, from the members' headers (nothing else read)."""
    import zipfile

    shapes = []
    with zipfile.ZipFile(path) as z:
        for name in sorted(z.namelist()):
            with z.open(name) as f:
                fmt = np.lib.format
                read = (fmt.read_array_header_1_0 if fmt.read_magic(f) == (1, 0)
                        else fmt.read_array_header_2_0)
                shapes.append(tuple(read(f)[0]))
    return shapes


def trainer_phase(rng: np.random.Generator) -> dict:
    """Phase 7: ``python -m csts_torch.tools.run_net --cfg <the Ego4D forecast
    yaml>`` on the card through ``run_net.main``: the flagship at full width,
    bf16 over fp32 masters, batch 8, 2 epochs of 6 iterations, validation
    each epoch, the test of the npz it wrote; the preemption drill; the npz
    layout."""
    import tempfile

    from csts_torch.convert import to_jax
    from csts_torch.data import loader as loader_lib
    from csts_torch.tools import run_net
    from csts_torch.train import trainer as trainer_lib
    from csts_torch.utils import checkpoint as cu

    out: dict = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        split = _trainer_split(os.path.join(root, "data"), int(rng.integers(1 << 30)))
        pyths, pos_shape = _trainer_pyths(root)
        out["setup_s"] = time.perf_counter() - t0

        # what the run did: each step's entry time, CUDA events and launches,
        # the consumer's waits inside training epochs, the saves and loads
        seen = {"steps": [], "waits": [], "epochs": [], "saves": [], "loads": [], "in_train": False}
        make_step, next_batch = train_lib.make_train_step, loader_lib.DevicePrefetcher.__next__
        train_epoch, save, load = trainer_lib._train_epoch, cu.save_checkpoint, cu.load_checkpoint
        load_params, train_fn = cu.load_params_npz, trainer_lib.train

        def recording_step(*a, **k):
            step = make_step(*a, **k)

            def run(state, batch, gen, drop=None):
                before = {n: WRAPPERS[n].launches for n in COUNTED}
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t = time.perf_counter()
                start.record()
                res = step(state, batch, gen, drop)
                end.record()
                seen["steps"].append((t, start, end, {n: WRAPPERS[n].launches - before[n]
                                                      for n in COUNTED}))
                return res
            return run

        def timed_next(self):
            t = time.perf_counter()
            try:
                return next_batch(self)
            finally:
                if seen["in_train"]:
                    seen["waits"][-1].append(time.perf_counter() - t)

        def timed_epoch(*a, **k):
            seen["in_train"] = True
            seen["waits"].append([])
            t = time.perf_counter()
            try:
                return train_epoch(*a, **k)
            finally:
                seen["in_train"] = False
                seen["epochs"].append(time.perf_counter() - t)

        def timed(fn, key):
            def run(path, *a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = fn(path, *a, **k)
                torch.cuda.synchronize()
                seen[key].append((time.perf_counter() - t, path))
                return res
            return run

        def timed_save(*a, **k):
            t = time.perf_counter()
            path = save(*a, **k)
            seen["saves"].append((time.perf_counter() - t, path))
            return path

        def measured_train(cfg, device=None):
            torch.cuda.reset_peak_memory_stats()
            state = train_fn(cfg, device)
            seen["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            seen["final"] = cu.state_leaves(state)  # the JAX layout, on the host
            return state

        runs = {}
        try:
            train_lib.make_train_step = recording_step
            loader_lib.DevicePrefetcher.__next__ = timed_next
            trainer_lib._train_epoch = timed_epoch
            cu.save_checkpoint, cu.load_checkpoint = timed_save, timed(load, "loads")
            cu.load_params_npz = timed(load_params, "loads")
            trainer_lib.train = measured_train
            # the run: train, then test the npz it wrote (the yaml's 8 workers)
            a_out = os.path.join(root, "run_a")
            reset_launches()
            t = time.perf_counter()
            stats = run_net.main(_run_net_args(split, pyths, a_out, 8, True))
            out["run_s"] = time.perf_counter() - t
            launches = {name: WRAPPERS[name].launches for name in COUNTED}
            runs["a"] = {k: list(v) if isinstance(v, list) else v for k, v in seen.items()}
            for key in ("steps", "waits", "epochs"):
                seen[key] = []
            # a second uninterrupted run: the spread between two runs
            b_out = os.path.join(root, "run_b")
            run_net.main(_run_net_args(split, pyths, b_out, DRILL_WORKERS, False))
            runs["b"] = seen.pop("final")
            # the drill: SIGTERM injected mid-epoch, then auto-resume to the end
            c_out = os.path.join(root, "run_c")
            trainer_lib._PREEMPT_AFTER_ITERS = PREEMPT_AFTER
            try:
                run_net.main(_run_net_args(split, pyths, c_out, DRILL_WORKERS, False))
            finally:
                trainer_lib._PREEMPT_AFTER_ITERS = None
            mid = cu.get_last_checkpoint(c_out)
            mid_meta = cu.checkpoint_meta(mid)
            run_net.main(_run_net_args(split, pyths, c_out, DRILL_WORKERS, False))
            runs["c"] = seen.pop("final")
            assert cu.get_last_checkpoint(c_out) == mid  # the drill's runs save nothing else
        finally:
            train_lib.make_train_step, loader_lib.DevicePrefetcher.__next__ = make_step, next_batch
            trainer_lib._train_epoch, trainer_lib.train = train_epoch, train_fn
            cu.save_checkpoint, cu.load_checkpoint, cu.load_params_npz = save, load, load_params

        # the run's loop: step times, the loader's wait share, launches
        ra = runs["a"]
        per_epoch = TRAINER_TRAIN_ROWS // 8
        steps = ra["steps"]
        assert len(steps) == TRAINER_EPOCHS * per_epoch, len(steps)
        for _, _, _, per_step in steps:
            for name in ("attention", "attention_bwd", "mlp_tail_train", "t2_upsample"):
                assert per_step[name] == PER_STEP[name], (name, per_step)
        intervals = [steps[i + 1][0] - steps[i][0] for i in range(len(steps) - 1)
                     if (i + 1) % per_epoch]  # within an epoch
        step_ms = float(np.median(intervals[1:])) * 1e3  # after the first (warm-up) interval
        device_ms = [s.elapsed_time(e) for _, s, e, _ in steps]
        waits = [w for ep in ra["waits"] for w in ep[1:]]  # after each epoch's first batch
        first_waits = [ep[0] for ep in ra["waits"]]
        loop_s = sum(ra["epochs"]) - sum(first_waits)
        save_s, save_path = ra["saves"][-1]
        gb = os.path.getsize(save_path) / 1e9
        test_load_s = ra["loads"][-1][0]
        out.update(step_ms=step_ms, clips_per_s=8e3 / step_ms, intervals_ms=[x * 1e3 for x in
                                                                               intervals],
                   step_events_ms=device_ms, step_events_median_ms=float(np.median(device_ms[1:])),
                   loader_wait_s=sum(waits), loader_wait_share=sum(waits) / loop_s,
                   first_waits_s=first_waits, epochs_s=ra["epochs"], save_s=save_s, save_gb=gb,
                   test_load_s=test_load_s, peak_gib=ra["peak_gib"], launches=launches,
                   test_stats=stats)
        log(f"phase trainer: run_net train+test {out['run_s']:.1f} s (setup {out['setup_s']:.1f} s); "
            f"{len(steps)} steps at batch 8: {step_ms:.2f} ms/step = {8e3 / step_ms:.2f} train "
            f"clips/s (median iteration after warm-up, host clock, loader and metrics included; "
            f"each step's span by events, median {out['step_events_median_ms']:.2f} ms); loader "
            f"wait share {out['loader_wait_share']:.3f} after each epoch's first batch (first "
            f"waits {', '.join(f'{w:.2f}' for w in first_waits)} s); peak memory "
            f"{ra['peak_gib']:.2f} GiB ({CARD})")
        log("phase trainer launches per step (each step): K1 attention "
            f"{steps[-1][3]['attention']}, B8 attention_bwd {steps[-1][3]['attention_bwd']}, "
            f"B7 mlp_tail_train {steps[-1][3]['mlp_tail_train']}, K3 t2_upsample "
            f"{steps[-1][3]['t2_upsample']}; the whole run (train, val, test) {launches}")
        log(f"phase trainer checkpoint: save {save_s:.2f} s for {gb:.3f} GB (the final "
            f"epoch's npz), load for the test {test_load_s:.2f} s ({CARD})")
        for name in ("attention", "attention_bwd", "mlp_tail_train", "t2_upsample", "mlp_tail",
                     "block", "pool_block", "decoder_block"):
            assert launches[name] > 0, f"trainer run: {name} never launched"
        for k in ("f1", "recall", "precision", "auc"):
            assert np.isfinite(stats[k]) and 0.0 <= stats[k] <= 1.0, stats

        # the npz's JAX layout: 3P+4 leaves, params, mu, nu against param_leaf_names
        cfg = flagship_cfg()
        names = to_jax.param_leaf_names(cfg)
        p = len(names)
        a_path = cu.get_last_checkpoint(a_out)
        shapes = _npz_shapes(a_path)
        assert len(shapes) == 3 * p + 4, (len(shapes), p)
        for off in (0, p + 3, 2 * p + 3):
            for i, (name, shape) in enumerate(names):
                assert shapes[off + i] == shape, (off + i, name, shape)
        final_a = ra["final"]
        assert [leaf.shape for leaf in final_a] == shapes
        with np.load(a_path) as blob:
            for i in (p, p + 2, 3 * p + 3):  # the counts and the step
                assert int(blob[f"leaf_{i:05d}"]) == TRAINER_EPOCHS * per_epoch
            # the file holds the trained state (its first and last parameter)
            for i in (0, p - 1):
                assert np.array_equal(blob[f"leaf_{i:05d}"], final_a[i]), i
        log(f"phase trainer layout: {len(shapes)} leaves = 3·{p} + 4, params, mu and nu shaped "
            f"as param_leaf_names, counts {TRAINER_EPOCHS * per_epoch}; the .pyth's "
            f"pos_embed_spatial {pos_shape} resampled to the model's")

        # the drill against the run, held to the spread of two uninterrupted runs
        ga = _groups(final_a, p)
        spread = _diff(ga, _groups(runs.pop("b"), p))
        drill = _diff(ga, _groups(runs.pop("c"), p))
        out.update(spread=spread, drill=drill, preempt_meta={k: v for k, v in mid_meta.items()
                                                             if k != "cfg"},
                   resume_load_s=[t for t, path in seen["loads"] if path == mid])
        def line(d):
            return ", ".join(f"{g} {v['max']:.3g} (rms {v['rms']:.3g})" for g, v in d.items())

        log(f"phase trainer drill: SIGTERM injected after {PREEMPT_AFTER} iterations, saved "
            f"{os.path.basename(mid)} (iter {mid_meta.get('iter')}), resumed to the end; max|Δ| "
            f"against the run: {line(drill)}; two uninterrupted runs: {line(spread)}; resume "
            f"load {', '.join(f'{t:.2f}' for t in out['resume_load_s'])} s, the drill's save "
            f"{seen['saves'][-1][0]:.2f} s ({CARD})")
        assert mid.endswith(f"checkpoint_epoch_00000_iter_{PREEMPT_AFTER:07d}.npz"), mid
        assert drill["scalars"]["max"] == 0.0, drill
        for g, v in drill.items():
            # bit equality where two runs agree bit for bit; else the drill's
            # rms within twice the two runs' (the largest |Δ| saturates at
            # Adam's bound of about Σlr as soon as the runs differ at all, so
            # it cannot tell a faulty resume from the card's own spread; the
            # rms over millions of values can, and varies little run to run)
            if spread[g]["max"] == 0.0:
                assert v["max"] == 0.0, (g, v)
            else:
                assert v["rms"] <= 2 * spread[g]["rms"], (g, v, spread[g])
        del ga, final_a, runs
    torch.cuda.empty_cache()
    out.update(trainer_extras(rng))
    return out


def trainer_extras(rng: np.random.Generator) -> dict:
    """Beside the trainer, the raw step of one state: ACT_CHECKPOINT on
    against off at batch 8 (bf16), accum_steps 2 of 8 against one pass of 16
    (bf16), in turns, ms by CUDA events and peak memory; then both at batch
    16 in fp32 (TF32 off) from the same weights and masks: the loss and
    every gradient at the whole-step bars."""
    cfg = flagship_train_cfg()
    spec = build_spec(cfg)
    state = train_lib.create_train_state(cfg, spec, torch.Generator().manual_seed(SEED + 4),
                                         device="cuda")
    model = state.model
    batch = make_train_batch(rng, ACCUM_BATCH, spec)
    half = {k: v[:8] for k, v in batch.items()}
    gen = torch.Generator().manual_seed(SEED + 5)

    def measure(remat: bool, accum: int, data: dict) -> tuple:
        model.spec = dataclasses.replace(spec, remat=remat)
        step = train_lib.make_train_step(cfg, model.spec, STEPS_PER_EPOCH, accum_steps=accum)
        step(state, data, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = [m for m, _ in timed_steps(step, state, data, gen, 3)]
        return ms, torch.cuda.max_memory_allocated() / 2 ** 30

    res = {}
    for turn in range(2):
        for tag, remat, accum, data in (("act_off", False, 1, half), ("act_on", True, 1, half),
                                        ("b16_accum1", False, 1, batch),
                                        ("b16_accum2", False, 2, batch)):
            ms, peak = measure(remat, accum, data)
            r = res.setdefault(tag, {"ms": [], "peak_gib": 0.0})
            r["ms"] += ms
            r["peak_gib"] = max(r["peak_gib"], peak)
    for r in res.values():
        r["median_ms"] = float(np.median(r["ms"]))

    # fp32 gradients at batch 16: one pass against two micro-batches
    model.spec = dataclasses.replace(spec, dtype="float32", remat=False)
    gen2 = torch.Generator().manual_seed(SEED + 6)
    micro = [sample_drop_masks(spec, ACCUM_BATCH // 2, gen2, "cuda") for _ in range(2)]
    whole = [None if m[0] is None else tuple(torch.cat([x[j] for x in m]) for j in range(2))
             for m in zip(*micro)]
    snapshot = {n: p.detach().clone() for n, p in model.named_parameters()}

    def grads_of(accum, drop):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(snapshot[n])
        seen = {}
        update = state.optimizer.step

        def record(lr):
            seen.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})
            return update(lr)

        state.optimizer.step = record
        try:
            stats, _ = train_lib.make_train_step(cfg, model.spec, STEPS_PER_EPOCH,
                                                 accum_steps=accum)(state, batch, None, drop=drop)
        finally:
            del state.optimizer.step
        return float(stats["loss"]), seen

    loss1, g1 = grads_of(1, whole)
    loss2, g2 = grads_of(2, micro)
    norm = lambda t: float(torch.linalg.vector_norm(t.float()))  # noqa: E731
    total = float(np.sqrt(sum(norm(g) ** 2 for g in g1.values())))
    share = {n: norm(g2[n] - g1[n]) / (STEP_GRAD_RTOL * norm(g1[n]) + STEP_GRAD_FLOOR * total)
             for n in g1}
    worst = sorted(share.items(), key=lambda kv: -kv[1])[:3]
    dloss = abs(loss2 - loss1) / abs(loss1)
    res["fp32_check"] = {"loss_accum1": loss1, "loss_accum2": loss2, "loss_rel_err": dloss,
                         "bar_share_worst": worst}
    log(f"phase trainer ACT_CHECKPOINT at batch 8: off {res['act_off']['median_ms']:.2f} ms/step, "
        f"peak {res['act_off']['peak_gib']:.2f} GiB; on {res['act_on']['median_ms']:.2f} ms/step, "
        f"peak {res['act_on']['peak_gib']:.2f} GiB (steps in turns, CUDA events; {CARD})")
    log(f"phase trainer accumulation at effective batch {ACCUM_BATCH}: one pass "
        f"{res['b16_accum1']['median_ms']:.2f} ms/step, peak {res['b16_accum1']['peak_gib']:.2f} "
        f"GiB; accum_steps 2 {res['b16_accum2']['median_ms']:.2f} ms/step, peak "
        f"{res['b16_accum2']['peak_gib']:.2f} GiB ({CARD}); fp32 loss {loss2:.8g} vs {loss1:.8g} "
        f"(relative {dloss:.3g}), worst shares of the gradient bar "
        + ", ".join(f"{n} {e:.3g}" for n, e in worst))
    assert dloss <= STEP_LOSS_RTOL, (loss1, loss2)
    assert worst[0][1] <= 1.0, worst
    model.spec = spec
    del state, model, batch, half, snapshot, g1, g2
    torch.cuda.empty_cache()
    return {"extras": res}


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
            if "registers" in line or "spill" in line or "Potential Performance Loss" in line:
                log(f"  {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- phase 1b: the repaired widths ----------------------------------------
    t0 = time.perf_counter()
    widths = widths_phase()
    log(f"phase widths: {time.perf_counter() - t0:.2f} s")

    # --- phase 2: flagship model behind the predictor ------------------------
    cfg = flagship_cfg()
    cfg.TRAIN.MIXED_PRECISION = True
    spec = build_spec(cfg)
    ref_model = CSTS(dataclasses.replace(spec, dtype="float32"))  # the fp32 reference
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
    reset_launches()
    outs, req_s = [], []
    for video, audio in requests:
        t0 = time.perf_counter()
        outs.append(pred.predict(video, audio))
        req_s.append(time.perf_counter() - t0)
    launches = {name: WRAPPERS[name].launches for name in PER_FORWARD}
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
    with plain_twins(), torch.inference_mode():
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
    breakdown = profile_forward(lambda: pred.forward(v, a), fwd_ms, log=log)
    log(f"phase timing: forward batch 8 bf16 {fwd_ms:.2f} ms = {8e3 / fwd_ms:.2f} clips/s, "
        f"peak memory {peak_gib:.2f} GiB ({card})")

    # --- phase 4b: the hw2 path (ab_flags' hw2_skip) under the same predictor -
    t0 = time.perf_counter()
    hw2 = hw2_phase(pred, v, a)
    log(f"phase hw2: {time.perf_counter() - t0:.2f} s")
    del pred, v, a
    torch.cuda.empty_cache()

    # --- phase 4c: the blocks path (ab_block's stacks) ------------------------
    t0 = time.perf_counter()
    blocks = blocks_phase()
    log(f"phase blocks: {time.perf_counter() - t0:.2f} s")

    # --- phase 4d: the eval entry point (tester.test) on a synthetic split ----
    t0 = time.perf_counter()
    evals = eval_phase(rng)
    log(f"phase eval total: {time.perf_counter() - t0:.2f} s")

    # --- phase 5: the training path ------------------------------------------
    t0 = time.perf_counter()
    train = train_path(rng)
    log(f"phase train total: {time.perf_counter() - t0:.2f} s")

    # --- phase 6: training kernels against their plain versions --------------
    t0 = time.perf_counter()
    train_report = check_train_kernels(train.pop("calls"))
    whole_step = whole_step_check(rng)
    log(f"phase train checks: {time.perf_counter() - t0:.2f} s")

    # --- phase 7: the training entry point (run_net's train mode) -------------
    t0 = time.perf_counter()
    trainer = trainer_phase(rng)
    log(f"phase trainer total: {time.perf_counter() - t0:.2f} s")

    kernels = []
    for name, k in ALL_KERNELS.items():
        if name in KERNELS:
            rows = [r for r in report[name]["shapes"] if "ms" in r]
            count, path, n = "launches_per_forward", "serve", launches[name]
            err = report[name]["max_abs_err"]
        else:
            rows = train_report[name]["shapes"]
            count, path, n = "launches_per_step", "train", train["launches"][name]
            err = train_report[name]["max_abs_err"]
        per = lambda key: sum(r[key] * r[count] for r in rows)  # noqa: E731
        kernels.append({
            "name": name, "route": k["route"], "source": k["source"], "replaces": k["replaces"],
            "launches": n, "max_abs_err": err,
            "ms": per("ms"), "plain_ms": per("plain_ms"), "bound_ms": per("bound_ms"),
            "bound_by": "bytes" if per("bytes_ms") >= per("ops_ms") else "operations",
            "library_ms": None if k["library"] is None else per("library_ms"),
            # device time (torch.profiler) of the kernel and of the library
            # call, per forward or per step
            "device_ms": per("device_ms"),
            "library_device_ms": None if k["library"] is None else per("library_device_ms"),
            # ms and the bound per forward (serve) or per training step (train)
            "path": path, "launches_train": train["launches"][name],
            "launches_eval": evals["launches"].get(name, 0),
            # launches in the trainer phase's run: 12 steps, 2 validations, a test
            "launches_trainer": trainer["launches"].get(name, 0),
            # the whole blocks, phase 1 included, through this kernel and
            # through the K1+K2 route (whole-block kernels only)
            "block_ms": per("block_ms") if name in WHOLE_BLOCKS else None,
            "composite_ms": per("composite_ms") if name in WHOLE_BLOCKS else None,
            "block_device_ms": per("block_device_ms") if name in WHOLE_BLOCKS else None,
            "composite_device_ms": per("composite_device_ms") if name in WHOLE_BLOCKS else None,
        })
    for name, k in B9_KERNELS.items():
        res = {"hw2_upsample": hw2, "block_multihead": blocks}[name]
        rows = res["shapes"]
        per = lambda key: sum(r[key] * r["launches_per_forward"] for r in rows)  # noqa: E731
        kernels.append({
            "name": name, "route": k["route"], "source": k["source"], "replaces": k["replaces"],
            "launches": res["launches"], "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": per("ms"), "plain_ms": per("plain_ms"), "bound_ms": per("bound_ms"),
            "bound_by": "bytes" if per("bytes_ms") >= per("ops_ms") else "operations",
            "library_ms": None if k["library"] is None else per("library_ms"),
            "device_ms": per("device_ms"),
            "library_device_ms": None if k["library"] is None else per("library_device_ms"),
            # ms and the bound per run of the path: one batch-8 forward with
            # hw2_skip on (ab_flags), or one run of ab_block's 3-8-head stacks
            "path": k["path"], "launches_train": train["launches"][name],
            "launches_eval": evals["launches"].get(name, 0),
            "launches_trainer": trainer["launches"].get(name, 0),
            # the stacks through this kernel and through the K1+K2 route:
            # CUDA events, and the device's busy time (torch.profiler)
            "block_ms": res.get("block_ms"), "composite_ms": res.get("composite_ms"),
            "block_device_ms": res.get("block_device_ms"),
            "composite_device_ms": res.get("composite_device_ms"),
        })
    # yardsticks beside the kernels: cuBLAS's products alone at K2's and B7's
    # sites, SDPA's backward at B8's, B3's and B4's blocks against the same
    # blocks through the K1+K2 route, F.interpolate at B9a's (device ms)
    k2_rows = [r for r in report["mlp_tail"]["shapes"] if "ms" in r]
    b7_rows = train_report["mlp_tail_train"]["shapes"]
    b8_rows = train_report["attention_bwd"]["shapes"]
    b4_rows = [r for r in report["pool_block"]["shapes"] if "ms" in r]
    b3_rows = [r for r in report["block"]["shapes"] if "ms" in r]
    tot = lambda rows, key, count: sum(r[key] * r[count] for r in rows)  # noqa: E731
    yardsticks = {
        "k2_cublas_ms": tot(k2_rows, "cublas_ms", "launches_per_forward"),
        "k2_cublas_device_ms": tot(k2_rows, "cublas_device_ms", "launches_per_forward"),
        "b7_cublas_ms": tot(b7_rows, "cublas_ms", "launches_per_step"),
        "b7_cublas_device_ms": tot(b7_rows, "cublas_device_ms", "launches_per_step"),
        "b8_device_ms": tot(b8_rows, "device_ms", "launches_per_step"),
        "b8_sdpa_bwd_device_ms": tot(b8_rows, "library_device_ms", "launches_per_step"),
        "b3_device_ms": tot(b3_rows, "device_ms", "launches_per_forward"),
        "b3_block_device_ms": tot(b3_rows, "block_device_ms", "launches_per_forward"),
        "b3_k1k2_route_device_ms": tot(b3_rows, "composite_device_ms", "launches_per_forward"),
        "b4_device_ms": tot(b4_rows, "device_ms", "launches_per_forward"),
        "b4_block_device_ms": tot(b4_rows, "block_device_ms", "launches_per_forward"),
        "b4_k1k2_route_device_ms": tot(b4_rows, "composite_device_ms", "launches_per_forward"),
        "b9a_device_ms": tot(hw2["shapes"], "device_ms", "launches_per_forward"),
        "b9a_interpolate_device_ms": tot(hw2["shapes"], "library_device_ms",
                                         "launches_per_forward"),
    }
    log("yardsticks: K2 {k2_cublas_ms:.4f} ms cuBLAS products a forward (device "
        "{k2_cublas_device_ms:.4f}); B7 {b7_cublas_ms:.4f} a step (device {b7_cublas_device_ms:.4f}); "
        "B8 device {b8_device_ms:.4f} vs SDPA backward device {b8_sdpa_bwd_device_ms:.4f} a step; "
        "B3 device {b3_device_ms:.4f} a forward, its blocks {b3_block_device_ms:.4f} vs the same "
        "blocks through the K1+K2 route {b3_k1k2_route_device_ms:.4f} (device, phase 1 included); "
        "B4 device {b4_device_ms:.4f} a forward, its blocks {b4_block_device_ms:.4f} vs the same "
        "blocks through the K1+K2 route {b4_k1k2_route_device_ms:.4f} (device, phase 1 included); "
        "B9a device {b9a_device_ms:.4f} vs F.interpolate device {b9a_interpolate_device_ms:.4f} "
        "a forward with hw2_skip".format(**yardsticks) + f" ({card})")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "per_shape": report,
                   "forward_ms_batch8": fwd_ms, "clips_per_s_batch8": 8e3 / fwd_ms,
                   "request_s": dict(zip(map(str, REQUESTS), req_s)),
                   "peak_gib": peak_gib, "logits_max_abs_diff": dlogit,
                   "softmax_max_abs_diff": dsm, "profile": breakdown,
                   "hw2": hw2, "blocks": blocks, "yardsticks": yardsticks,
                   "train": train, "train_per_shape": train_report,
                   "train_fp32_step": whole_step, "widths": widths, "eval": evals,
                   "trainer": trainer}, f, indent=1,
                  default=str)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

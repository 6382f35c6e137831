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
  4. the serving path (a bucket's first request ran eagerly in phase 2, its
     second captures a CUDA graph over its static buffers, later ones
     replay): launch counters set to 0, requests of 1, 5 and 8 clips (the
     captures of buckets 1 and 8, then a replay), counters read (each its
     launches per forward times the 2 captures); outputs checked (shapes,
     finite, each frame's heatmap sums to 1) and held against the same
     weights through the plain versions in fp32 on the card; at buckets 1
     and 8 the replay bit-equal to the eager ``forward`` on the same
     inputs, and one replay's device kernels counted by name
     (``torch.profiler``) equal to the eager forward's, each kernel at its
     launches per forward; requests of 1, 5 and 8 clips from host memory,
     20 of each after 3 warm-ups, median and p90 ms beside the replay's
     device time and the host's share; ``export_compiled`` on the card for
     buckets (1, 8) into a temporary directory and ``from_exported`` (size,
     seconds), its predictor through the kernels (launches counted) against
     the live one (bit-equal, else the golden bar); a loopback
     ``GazeHTTPServer``: 8 client threads posting 8 one-clip requests each
     (two of them raw uint8 frames at 256x320), clips/s, p50/p99,
     occupancy, every answer within the golden bar of a direct predict;
     ``hw2_skip`` flipped after the capture (the next request launches B9a,
     no stale replay); the batch-8 forward timed and profiled (device time
     by kernel family), and at batches 8 and 1 timed through the kernels'
     custom ops and through their launches directly, in turns (the
     dispatcher's cost);
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
     parameter's gradient compared; the same step under the switches of
     5b(b) beside it); one bf16 batch-8 step with the plain attention twin
     in place of K1+B8 (TRAIN_ATTN off), timed beside the kernels' step;
 5b. the JAX package's kernel switches (``switches_phase``, at the
     flagship's width, TF32 off): (a) K1 (v4 unmasked: K1 forward and B8;
     the spatial fusion's masked shape: K1 and the plain recompute), K2 (v4
     and the first dim-change site) and B3 (v0) differentiated on the card
     through their wrappers at batch 1 in fp32, against autograd of their
     plain twins at the JAX suite's gradient bars (``GRAD_BARS``), and B4,
     B5, the eval K3 and B9a refusing a gradient ("inference-only"); (b)
     phase 6's fp32 step at batch 2 (its weights, masks and batch) with
     TRAIN_DECODER on (B5 at d2-d4 in the step, its backward the composite
     recompute) and with TRAIN_ATTN off, each against the same step through
     the plain twins at the whole-step bars, launches against
     ``train_plan`` (``mvit.train_route``); (c) the card's A/B of JAX's four
     training routes (TRAIN_ATTN off, off with TRAIN_DECODER, on, on with
     TRAIN_DECODER) at batch 8 in bf16: ms/step by CUDA events in turns,
     device busy ms of a traced step, peak memory, launches a step against
     ``train_plan``;
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
     uninterrupted run, bit-equal to the first, then the preemption drill
     (SIGTERM injected after 3 iterations, an iter-tagged save, auto-resume
     to the end), bit-equal to the run; 7c: the second run saves each epoch
     through TRAIN.CHECKPOINT_BACKEND "orbax" (``utils/orbax_ckpt.py``:
     steps 6 and 12; per save the seconds ``save`` blocked, the seconds
     until the step committed, the bytes on disk, the steps that ran during
     the write), its step 6 resumed, SIGTERM injected after 3 iterations of
     epoch 2 (step 9), resumed to step 12, bit-equal to the run; step 12
     restored into the drill's final state (every value spoiled first)
     equal to the run's ``state_leaves`` leaf for leaf, and the npz save of
     that state timed beside it; the max-pool backward in its fixed
     order against CUDA's own (atomics) at the trainer's shapes, in turns;
     beside it the raw step
     with ACT_CHECKPOINT on and off at batch 8 and with accum_steps 2 of 8
     against one pass of 16 (ms, peak memory), and both in fp32 at batch 16
     at the whole-step bars;
  8. several processes: two spawned ranks share the card over gloo (NCCL
     refuses two ranks on one device: ``tests/test_torch_cuda.py``
     ``test_two_ranks_on_one_card_need_gloo``), the kernels built once
     before the spawn. 8a: the flagship
     from ``flagship_train_cfg`` in fp32 (TF32 off), global batch 2 (1 a
     rank), kldiv+egonce, drop-path 0.2, 2 steps through DDP and the
     trainer's own step, against one process at batch 2 from the same
     weights, batch and masks at phase 6's whole-step bars (the loss, every
     gradient after step 1; the params after step 2 within 2·Σlr), each
     rank's launches a step (K1 26, B8 25, B7 26, K3 2); then bf16 at global
     batch 8 (4 a rank), 3 steps timed and one traced (device busy ms and its
     copies: gloo stages the gradient all-reduce through the host), "two
     ranks sharing one card", no scaling figure. 8b: ZeRO-1 the same way,
     against one process and against DDP, each rank holding its share of
     the moments; FSDP under NCCL at world size 1 (gloo cannot run DTensor's
     functional collectives on CUDA tensors; FSDP across ranks is held on
     the CPU), against one process; each mode's npz (3P+4 leaves, DDP's
     layout, params within the bar). 8c: ``tester.test`` on two ranks at
     flagship width, bf16, 20 synthetic clips at one and two views
     (TEST.BATCH_SIZE 6: an empty stripe, clips straddling the stripes):
     F1, recall, precision, threshold and AUC within 1e-6 of one process,
     the results npz equal, every row scored once; then one
     ``init_from_cfg`` group under NCCL at world size 1 (run_net's backend)
     through two trainer iterations with the launches counted;
  9. the forward's whole surface at flagship width (bf16, 256², seeded
     weights): a batch-8
     forward with both fusion maps and ``extract_activations`` over
     ``CAPTURABLE``, launches against ``route_plan`` (``mvit.block_route``:
     K1 leaves the two fusion blocks), the logits against the same forward
     without maps at the golden bar and the maps against the fp32 plain
     twins (max|Δ| < 0.02); MVIT.SPATIAL_AUDIO_ATTN's forward against its
     fp32 plain twins and one training step (loss and grad norm finite, K1
     25 a step); ``head_commute`` and ``t2_skip`` each flipped under one
     predictor (the stale graph dropped, a new one captured, then replayed;
     K3 0 with t2_skip off; per-frame softmax within the golden bar of the
     defaults'); run_net's training, one epoch of 6 iterations, with and
     without AUG.ENABLE at 4 loader workers (launches, the loader's wait
     share, no worker alive after); ``tools/visualize.py --attention`` on 4
     test clips from that run's npz (every PNG read back at its size);
 10. the MViT-B 16x4 classifier (``presets.mvit_b_16x4_cfg``: 16 frames at
     224², 16 blocks, 400 classes) from ``build_model`` with seeded weights,
     bf16, with the cls token (the published configuration) and without
     it: ``classifier_plan`` (``mvit.block_route``: K1 16 and K2 16 with the
     token, B3 2, K1 14 and K2 14 without), then at batches 1 and 8 one
     forward recording every launch's inputs and one with the counters set
     to 0 before and read after, against the plan; the logits against the
     same weights through the fp32 plain twins (max|Δ| within 0.05 of
     max(1, the largest |logit|), the class softmax within 1e-3, the top
     class where decided); every recorded K1, K2 and B3 launch against its
     plain twin (``check_kernels``, K1 also against its split model where
     it splits the keys) with device ms (``device_reading``: two whole
     profiler windows that agree, else "not measured") and the bound at
     batch 8; the batch-8 forward's ms (events) and clips/s, and its device
     busy ms by kernel family (``profile_forward``) from a window holding
     every activity of the port's kernels that the launches make (else "not
     measured"); then the native loader ops (``csts_torch/native``, g++ at
     first use) bit-equal to their numpy twins at the flagship loader's
     shapes, and ``utils.misc.benchmark_data_loading`` on a synthetic train
     split (32 clips at 256x320 listed 36 times, 4 workers, 128 batches of
     8 timed, the clips read from the page cache);
 11. the model axes (``axes_phase``): two gloo ranks sharing the card
     (``spawn_ranks``), a mesh of pipe, then model, then seq at 2: the
     flagship's bf16 eval forward at batch 8 against one process
     (``heatmap_check``), one fp32 step at global batch 2 (TF32 off,
     drop-path 0.2, the global masks) against one process at phase 6's
     whole-step bars, each rank's launches against the axis's plan (pipe:
     v4-v11 in 2 stages of 4 at M = 2), the collectives run, the model
     axis's split leaves and moments, each rank's ms a forward and a step
     (CUDA events); then ``GazePredictor(devices=[cuda:0])`` bit-equal to
     the plain predictor at buckets 1 and 8 (eager, capture, replay), the
     preprocessing CLI's ``check`` and ``splits`` over a synthetic split,
     whether an ffmpeg binary is present, and the TENSORBOARD.ENABLE
     records of phase 7's second run; 11e, the axes composed: SEQ=2 x
     PIPE=2 (the forward and the step, the pipelined run on the stripes)
     and DATA=2 x MODEL=2 under SOLVER.ZERO1 (the step, each rank's moment
     share, rank 0's npz loaded into one process; 7c: the orbax backend's
     step beside it, each rank's bytes, restored into one process and into
     DATA=2 on two ranks, each equal to the npz) on four gloo ranks
     sharing the card, SOLVER.FSDP under PIPE=2 and under SEQ=2 on two
     gloo ranks whose data axis is a one-rank NCCL group each, every
     layout against one process, its launches and ms a rank.
Every process the run starts is audited (``ProcessAudit``): a thread reads
this process's descendants from ``/proc`` twice a second, and each phase
ends with a ``phase X: processes after: n`` line naming those alive. At the
end, before the ``kernels`` line, every loader still open is closed, the
HTTP server's and micro-batcher's threads must be gone (spawned ranks are
checked gone where ``spawn_ranks`` joins them), ``multiprocessing``'s fork
server and resource tracker are stopped, and no process seen during the
run may be alive: the run prints ``processes left: 0``, or fails naming
each leftover pid, its cmdline and the phase that first saw it.
It prints the ``kernels`` JSON line, the card line and, last, the result line.
``python3 chip_smoke.py --determinism`` is a one-off beside it: the build and
phase 7 alone under ``torch.use_deterministic_algorithms(True, warn_only=True)``,
printing the ops it names (``determinism_probe``). ``python3 chip_smoke.py
--parallel`` is the build and phase 8 alone, ``--axes`` the build and phase
11 alone, ``--trainer`` the build and phase 7 alone, ``--switches`` the build
and phase 5b alone, ``--conditioning`` the build and phase 6b's fp32 step
without its bars on six batches, under the default switches and 5b(b)'s
(``conditioning_probe``).
Per-shape details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.request

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
from csts_torch import ops as tops  # noqa: E402
from csts_torch.ops import conv as oc  # noqa: E402
from csts_torch.ops import sample_drop_masks  # noqa: E402
from csts_torch.data import loader as loader_lib  # noqa: E402
from csts_torch.parallel import collectives, mesh  # noqa: E402
from csts_torch.presets import flagship_cfg, flagship_train_cfg  # noqa: E402
from csts_torch.serving import GazePredictor  # noqa: E402
from csts_torch.serving_server import GazeHTTPServer  # noqa: E402
from csts_torch.tools import (ab_block, ab_flags, card_line, direct_launches,  # noqa: E402
                              plain_twins, softmax_check)
from csts_torch.tools.ab_kernels import b4_inputs, tail_inputs  # noqa: E402
from csts_torch.tools.profile_forward import (FAMILIES, PORT_FAMILIES, WINDOWS,  # noqa: E402
                                              device_ms, device_reading, device_trace,
                                              family, kernel_counts, profile_forward)
from csts_torch.train import step as train_lib  # noqa: E402
from csts_torch.train.losses import frame_softmax  # noqa: E402
from csts_torch.utils import checkpoint as cu  # noqa: E402
from csts_torch.utils import orbax_ckpt  # noqa: E402
from csts_torch.utils import procs  # noqa: E402

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
# the device kernel each wrapper launches exactly once a call (its other
# kernels, such as K1's key-split merge or K2's LN2 and fc1, vary with the
# shape or are shared): what a graph replay is counted by
PRIMARY_KERNEL = {"attention": ("attn_wg_kernel", "attn_streamed_kernel"),
                  "mlp_tail": ("tail_fc2_kernel", "mlp_tail_f32_kernel"),
                  "t2_upsample": ("t2_upsample_kernel",), "block": ("block_attn_kernel",),
                  "pool_block": ("pool_attn_kernel",), "decoder_block": ("decoder_attn_kernel",),
                  "hw2_upsample": ("hw2_upsample_kernel",)}
LATENCY_REQUESTS = 20  # timed requests of each size, after LATENCY_WARMUP
LATENCY_WARMUP = 3
SERVICE_CLIENTS = 8    # client threads, each posting SERVICE_POSTS one-clip requests
SERVICE_POSTS = 8
SERVICE_CLIPS = 8      # distinct clips the requests cycle through
SERVICE_RAW = (256, 320)  # two requests carry raw uint8 frames of this size
DISPATCH_TURNS = 3  # turns of the eager forward through the ops and direct launches
KERNEL_FAMILIES = {f for f, _ in FAMILIES[:10]}  # the port's kernels' families
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


def _ms(x) -> str:
    """A time for the log: "not measured" where the profiler gave none."""
    return "not measured" if x is None else f"{x:.4f}"


def _total(rows: list, key: str, count: str):
    """Σ row[key] × row[count] over ``rows``: a path's time from its shapes'
    (None where a shape's time is None: not measured)."""
    vals = [(r[key], r[count]) for r in rows]
    return None if any(v is None for v, _ in vals) else sum(v * n for v, n in vals)


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
# launches per training step on the flagship under the default switches
# (``train_plan`` derives them from ``mvit.train_route``; phase 5 holds the
# two equal): K1 forward and B7 at all 26 blocks (16 video, 4 audio, 2
# fusion, 4 decoder), B8 at the 25 without a mask (the spatial fusion's
# backward is the plain recompute), K3 at d4's skip and the stem skip; K2,
# B3 and B4 are eval only, B5 runs in training only under TRAIN_DECODER
PER_STEP = {"attention": 26, "mlp_tail_train": 26, "attention_bwd": 25, "t2_upsample": 2,
            "mlp_tail": 0, "block": 0, "pool_block": 0, "decoder_block": 0, "hw2_upsample": 0}
TRAIN_STEPS = 3
STEPS_PER_EPOCH = 1000  # the lr schedule's epoch is step / STEPS_PER_EPOCH
CARD = ""  # nvidia-smi's name and power limit, printed beside every time


def log(msg: str) -> None:
    print(msg, flush=True)


AUDIT_SAMPLE_S = 0.5  # the process audit reads this process's descendants this often
AUDIT_GRACE_S = 10.0  # at the end, how long an exiting process may take to be gone


# each phase's profiler windows (``profile_forward.WINDOWS``) and their summary
PROFILER_WINDOWS: dict = {}


def profiler_windows(phase: str) -> dict:
    """Moves the profiler windows traced since the last call into
    PROFILER_WINDOWS under ``phase`` and logs what they show: the calls'
    launches whose activity no window held, the priming launches lost (the
    first of each window, ``profile_forward.PRIMING_LAUNCHES``), and the
    least gap from a launch to its activity's start (below 0 only where the
    device's clock and the host's disagree)."""
    recs = [r for r in WINDOWS if r.get("recorded")]
    WINDOWS.clear()
    gaps = [r["least_gap_us"] for r in recs if r["least_gap_us"] is not None]
    summary = {"windows": len(recs), "launches": sum(r["launches"] for r in recs),
               "lost": sum(r["lost"] for r in recs),
               "priming_lost": sum(r["priming_lost"] for r in recs),
               "windows_losing": sum(bool(r["lost"]) for r in recs),
               "least_gap_us": [min(gaps), max(gaps)] if gaps else None,
               "window_start_us": ([min(r["window_us"] for r in recs),
                                    max(r["window_us"] for r in recs)] if recs else None)}
    PROFILER_WINDOWS[phase] = {**summary, "records": recs}
    if recs:
        log(f"phase {phase}: profiler windows {summary['windows']}, launches "
            f"{summary['launches']}, lost {summary['lost']} in {summary['windows_losing']} "
            f"windows (priming launches lost {summary['priming_lost']}); least "
            f"launch-to-activity gap {summary['least_gap_us']} µs; window start "
            f"{summary['window_start_us']} µs from the call")
    return summary


class ProcessAudit:
    """Every process the run starts: a thread reads this process's
    descendants from ``/proc`` every AUDIT_SAMPLE_S seconds (so the short-lived
    ones are seen too: nvcc, spawned ranks and their loader workers), and each
    phase boundary reads and logs those alive. :meth:`finish` fails the run
    if any process it saw is alive at the end."""

    def __init__(self):
        self.seen = {}  # (pid, start time) -> (cmdline, the phase that first saw it)
        self.phase = "build"
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, name="process-audit", daemon=True)
        self._thread.start()

    def _record(self) -> dict:
        now = procs.descendants()
        with self._lock:
            for pid, (start, cmd) in now.items():
                self.seen.setdefault((pid, start), (cmd, self.phase))
        return now

    def _sample(self) -> None:
        while not self._stop.wait(AUDIT_SAMPLE_S):
            self._record()

    def at(self, phase: str) -> dict:
        """Ends the current phase (logs the processes alive after it) and
        names the next."""
        now = self._record()
        profiler_windows(self.phase)
        log(f"phase {self.phase}: processes after: {len(now)}"
            + "".join(f"; {pid} {cmd[:100]}" for pid, (_, cmd) in sorted(now.items())))
        self.phase = phase
        return now

    def finish(self) -> dict:
        """After the closing steps: asserts that no process seen during the
        run, and no current descendant, is alive (zombies have exited)."""
        self.at("end")
        self._stop.set()
        self._thread.join()
        seen = dict(self.seen)
        for pid, (start, cmd) in procs.descendants().items():
            seen.setdefault((pid, start), (cmd, "end"))
        deadline = time.monotonic() + AUDIT_GRACE_S
        while True:
            left = {key: v for key, v in seen.items() if procs.alive(*key)}
            if not left or time.monotonic() >= deadline:
                break
            time.sleep(0.1)
        for (pid, _), (cmd, phase) in sorted(left.items()):
            log(f"process left: pid {pid}, first seen in phase {phase}: {cmd}")
        assert not left, f"{len(left)} process(es) the run started are alive at its end"
        log(f"processes left: 0 (of {len(seen)} seen during the run)")
        return {"seen": len(seen), "left": 0}


def close_run(audit: ProcessAudit) -> dict:
    """The run's closing steps, in order: every loader closed, the HTTP
    server's and micro-batcher's threads gone, multiprocessing's fork
    server and resource tracker stopped, then the audit (``processes left:
    0``). Spawned ranks are checked gone where they are joined
    (``spawn_ranks``)."""
    audit.at("closing")
    closed = loader_lib.close_all()
    serving = [t.name for t in threading.enumerate()
               if t.name in ("gaze-http", "gaze-microbatcher")]
    log(f"closing: {closed} loader(s) still open closed; serving threads alive: {serving}")
    assert not serving, serving
    procs.stop_mp_helpers()
    return audit.finish()


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

    def forward(self, x, thw, mask=None, drop=None, return_attn=False):
        block_in[:] = [self, x, thw]
        return block_forward(self, x, thw, mask, drop, return_attn)

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
def train_switches(attn: bool = True, decoder: bool = False):
    """The JAX package's training switches for the block: TRAIN_ATTN
    (``ka.set_train_attention``) and TRAIN_DECODER
    (``ka.set_train_decoder``), both restored on exit. The defaults are
    the port's (TRAIN_ATTN on, TRAIN_DECODER off)."""
    saved = ka.train_attention_enabled(), ka.train_decoder_enabled()
    ka.set_train_attention(attn)
    ka.set_train_decoder(decoder)
    try:
        yield
    finally:
        ka.set_train_attention(saved[0])
        ka.set_train_decoder(saved[1])


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


def check_kernels(calls_by_bucket: dict, kernels: dict = KERNELS, timing="full") -> dict:
    """Phase 3: every kernel of ``kernels`` against its plain version at every
    recorded shape (a kernel's ``bars`` name the bars it takes, its ``peak``
    the peak rate of its operations). At the largest bucket's shapes
    ``timing`` "full" times the kernel, its plain version and its library
    call by CUDA events and by device time (and a whole block through the
    K1+K2 route); "device" takes the device times and the bound only; None
    times nothing."""
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
                if bucket == max(calls_by_bucket) and timing is not None:
                    nbytes, flops = k["cost"](*args)
                    dev, acts = device_reading(lambda: kern(*args))
                    row.update(
                        device_ms=dev, activities=acts,
                        library_device_ms=(device_ms(lambda: k["library"](*args))
                                           if k["library"] is not None else None),
                        bytes=nbytes, flops=flops, bytes_ms=nbytes / PEAK_BYTES_S * 1e3,
                        ops_ms=flops / k.get("peak", PEAK_BF16_FLOPS) * 1e3)
                    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
                    line = (f"device {_ms(row['device_ms'])} (library device "
                            f"{_ms(row['library_device_ms'])}, bound {row['bound_ms']:.4f} = bytes "
                            f"{row['bytes_ms']:.4f} / ops {row['ops_ms']:.4f}")
                    if timing == "full":
                        row.update(ms=time_ms(lambda: kern(*args)),
                                   plain_ms=time_ms(lambda: plain(*args)),
                                   library_ms=(time_ms(lambda: k["library"](*args))
                                               if k["library"] is not None else None))
                        line = (f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, library "
                                f"{_ms(row['library_ms'])}; " + line)
                        if k.get("yardstick") is not None:
                            run = k["yardstick"](*args)
                            row.update(cublas_ms=time_ms(run), cublas_device_ms=device_ms(run))
                            line += (f"; cuBLAS products {row['cublas_ms']:.4f} / device "
                                     f"{_ms(row['cublas_device_ms'])}")
                        if ctx is not None:
                            # the whole block, phase 1 included, through this
                            # kernel and through the K1+K2 route
                            blk, x_in, thw = ctx
                            row["block_ms"] = time_ms(lambda: blk(x_in, thw))
                            row["composite_ms"] = time_ms(lambda: blk.forward_composite(x_in, thw))
                            row["block_device_ms"] = device_ms(lambda: blk(x_in, thw))
                            row["composite_device_ms"] = device_ms(
                                lambda: blk.forward_composite(x_in, thw))
                            line += (f"; whole block {row['block_ms']:.4f} (device "
                                     f"{_ms(row['block_device_ms'])}) vs K1+K2 route "
                                     f"{row['composite_ms']:.4f} (device "
                                     f"{_ms(row['composite_device_ms'])})")
                    log(f"  {name} {sig[0]} x{count}: {line}) max|Δ| bf16 {err:.3g} fp32 "
                        f"{err32:.3g}" + (f" splits {split['splits']}" if split else "")
                        + f" ({CARD})")
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
    plan = train_plan(state.model)
    assert plan == PER_STEP, f"train_route's plan {plan} is not PER_STEP {PER_STEP}"
    for name, per in PER_STEP.items():
        need = per * TRAIN_STEPS
        assert launches[name] == need, f"train {name}: {launches[name]} launches, expected {need}"

    profile = profile_forward(lambda: step(state, batch, gen), step_ms, log=log)
    # TRAIN_ATTN off (the plain attention core in place of K1 + B8), in turns
    # with the kernels
    kern, plain = [ms for ms, _ in steps], []
    for _ in range(3):
        with train_switches(attn=False):
            plain += [ms for ms, _ in timed_steps(step, state, batch, gen, 4)[1:]]
        kern += [ms for ms, _ in timed_steps(step, state, batch, gen, 3)]
    plain_ms, kern_ms = float(np.median(plain)), float(np.median(kern))
    log(f"phase train plain attention: median {plain_ms:.2f} ms/step with TRAIN_ATTN off, the "
        f"plain attention core ({', '.join(f'{x:.1f}' for x in plain)}) vs {kern_ms:.2f} "
        f"through K1 + B8 "
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
            log(f"  {name} {sig[0]} x{count}: {row['ms']:.4f} ms, device {_ms(row['device_ms'])} "
                f"(plain {row['plain_ms']:.4f}, library {row['library_ms']} / device "
                f"{_ms(row['library_device_ms'])}, bound {row['bound_ms']:.4f} = bytes "
                f"{row['bytes_ms']:.4f} / ops {row['ops_ms']:.4f}"
                + (f"; cuBLAS products {row['cublas_ms']:.4f} / device "
                   f"{_ms(row['cublas_device_ms'])}" if "cublas_ms" in row else "")
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


# the relative change of the inputs (video and audio) by which the plain
# twins' step is moved against itself: how far the objective alone carries a
# rounding-sized change into the gradients, beside the kernels' shares of the bar
PERTURB = 1e-7


def whole_step_check(rng: np.random.Generator, combos=(("default", {}),),
                     check: bool = True) -> dict:
    """Phase 6b (and 5b(b)): one fp32 step at batch 2 (TF32 off) through the
    kernels under each of ``combos`` ((tag, ``train_switches`` arguments))
    and through the plain twins (the kernels switched off, JAX's composite
    route), from the same weights, masks and batch: the loss and every
    parameter's gradient at the whole-step bars (asserted when ``check``),
    and each kernel run's launches against ``train_plan`` under its
    switches. Beside them the plain twins' step against itself with the
    video and audio scaled by 1 + PERTURB (logged, not held to a bar).
    Returns {tag: readings}."""
    cfg = flagship_train_cfg()
    cfg.TRAIN.MIXED_PRECISION = False
    cfg.TRAIN.BATCH_SIZE = 2
    spec = build_spec(cfg)
    model = CSTS(spec)
    init_params(model, torch.Generator().manual_seed(SEED))
    model = model.cuda().train()
    batch = make_train_batch(rng, 2, spec)

    def loss_and_grads(scale: float = 1.0):
        model.zero_grad(set_to_none=True)
        drop = sample_drop_masks(spec.video_blocks, 2, torch.Generator().manual_seed(SEED + 2),
                                 "cuda")
        inputs = dict(batch, video=batch["video"] * scale, audio=batch["audio"] * scale)
        loss, _, _ = train_lib.forward_loss(cfg, model, inputs, drop)
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().clone() if p.grad is not None
                             else torch.zeros_like(p) for n, p in model.named_parameters()}

    with plain_twins():
        loss_p, grads_p = loss_and_grads()
        _, grads_q = loss_and_grads(1.0 + PERTURB)
    norm = lambda t: float(torch.linalg.vector_norm(t.float()))  # noqa: E731
    total = float(np.sqrt(sum(norm(g) ** 2 for g in grads_p.values())))
    floor = STEP_GRAD_FLOOR * total

    def worst_shares(grads) -> list:
        # each gradient's error as a share of its bar (fails above 1)
        share = {n: norm(grads[n] - grads_p[n]) / (STEP_GRAD_RTOL * norm(grads_p[n]) + floor)
                 for n in grads_p}
        return sorted(share.items(), key=lambda kv: -kv[1])[:5]

    perturbed = worst_shares(grads_q)
    del grads_q
    log(f"phase train fp32 step: the plain twins' step against itself with the video and audio "
        f"scaled by 1 + {PERTURB:g}: worst shares of the bar "
        + ", ".join(f"{n} {e:.3g}" for n, e in perturbed))
    out = {}
    for tag, switches in combos:
        with train_switches(**switches):
            plan = train_plan(model)
            reset_launches()
            loss_k, grads_k = loss_and_grads()
        launches = {name: WRAPPERS[name].launches for name in PER_STEP}
        rel = {n: rel_err(grads_k[n], grads_p[n]) for n in grads_p if norm(grads_p[n]) > floor}
        worst = worst_shares(grads_k)
        worst_rel = max(rel.values())
        dloss = abs(loss_k - loss_p) / abs(loss_p)
        log(f"phase train fp32 step ({tag}): loss {loss_k:.8g} vs plain {loss_p:.8g} (relative "
            f"{dloss:.3g}); {len(grads_p)} gradients (whole norm {total:.4g}), worst relative "
            f"norm {worst_rel:.3g} among the {len(rel)} above the floor; worst shares of the bar "
            + ", ".join(f"{n} {e:.3g}" for n, e in worst) + f"; launches {launches}")
        assert launches == plan, f"the fp32 step ({tag}) launched {launches}, plan {plan}"
        if check:
            assert dloss <= STEP_LOSS_RTOL, (tag, loss_k, loss_p)
            assert worst[0][1] <= 1.0, (tag, worst)
        out[tag] = {"loss": loss_k, "loss_plain": loss_p, "loss_rel_err": dloss,
                    "grad_norm": total, "grad_rel_err_max": worst_rel,
                    "bar_share_worst": worst, "launches": launches,
                    "plain_perturbed_bar_share_worst": perturbed}
        del grads_k
    del model, grads_p
    torch.cuda.empty_cache()
    return out


CONDITIONING_BATCHES = 6


def conditioning_probe(t_start: float, audit: ProcessAudit) -> int:
    """``--conditioning``: the build, then ``whole_step_check`` without its
    bars on CONDITIONING_BATCHES batches (drawn from their own seeds), each
    under the default switches, TRAIN_DECODER on and TRAIN_ATTN off, beside
    the plain twins' step against itself with the inputs scaled by 1 +
    PERTURB: whether a share of the whole-step bar above 1 follows the
    kernels, a switch or the batch (ROADMAP C, the ill-conditioned
    objective). JSON to ``chiprun_out/chip_smoke_conditioning.json``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase build: {time.perf_counter() - t_start:.2f} s")
    audit.at("conditioning")
    res = []
    for i in range(CONDITIONING_BATCHES):
        log(f"conditioning batch {i} (seed {SEED + 100 + i}):")
        res.append(whole_step_check(np.random.default_rng(SEED + 100 + i),
                                    (("default", {}),) + SWITCH_STEP_COMBOS, check=False))
    processes = close_run(audit)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_conditioning.json"), "w") as f:
        json.dump({"card": CARD, "batches": res, "processes": processes}, f, indent=1,
                  default=str)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# --- phase 5b: the JAX package's kernel switches ----------------------------
# The bars of the kernel-level gradients (5b(a)) are the JAX suite's, each
# element |Δ| ≤ atol + rtol·|ref| against autograd of the plain twin: K1's
# (tests/test_pallas_attention.py test_fused_gradients_match and
# test_masked_gradients_use_composite_fallback) 1e-4 and 1e-4, K2's and B3's
# (tests/test_fused_block.py test_mlp_tail_gradients and
# test_fused_block_gradients) 1e-3 and 1e-3. K1's backward is B8 (or the
# masked recompute), K2's and B3's recompute their plain twins.
GRAD_BARS = {"attention": (1e-4, 1e-4), "mlp_tail": (1e-3, 1e-3), "block": (1e-3, 1e-3)}
# 5b(b): the switch settings that change the training route, each one fp32 step
SWITCH_STEP_COMBOS = (("train_decoder", {"decoder": True}), ("train_attn_off", {"attn": False}))
# 5b(c): the card's A/B of the JAX package's four training routes (the
# counterpart of the TPU table in csts_tpu/kernels/attention.py:52-57)
SWITCH_ROUTES = (("train_attn_off", {"attn": False}),
                 ("train_attn_off+train_decoder", {"attn": False, "decoder": True}),
                 ("train_attn", {}), ("train_attn+train_decoder", {"decoder": True}))
SWITCH_AB_ROUNDS, SWITCH_AB_STEPS = 3, 4
GRAD_BATCH = 1


def _video_site(spec, i: int):
    """(thw, block spec) of the flagship's video block ``i``."""
    from csts_torch.models.csts import _thw_after_blocks

    return _thw_after_blocks(spec.patch_dims, spec.video_blocks[:i]), spec.video_blocks[i]


def _linear(gen, n_out: int, n_in: int):
    """An nn.Linear's weight and bias on the card, uniform in ±1/sqrt(n_in)."""
    bound = n_in ** -0.5
    w = (torch.rand(n_out, n_in, generator=gen, device="cuda") * 2 - 1) * bound
    return w, (torch.rand(n_out, generator=gen, device="cuda") * 2 - 1) * bound


def _tail_weights(gen, c: int, cout: int, hidden: int) -> list:
    """LN2, fc1, fc2 and the dim-change proj (None, None when c == cout)."""
    ln = [1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
          0.1 * torch.randn(c, generator=gen, device="cuda")]
    proj = list(_linear(gen, cout, c)) if c != cout else [None, None]
    return ln + list(_linear(gen, hidden, c)) + list(_linear(gen, cout, hidden)) + proj


def _grad_case(tag: str, name: str, fn, plain, args: list, wrt: list) -> dict:
    """``fn(*args)`` under autograd on the card (the wrapper's Function:
    the kernel forward and its backward) against autograd of ``plain`` on
    the same fp32 inputs and one random output gradient: the output at the
    kernel's fp32 bar, and the gradient of each argument at the indices
    ``wrt`` at GRAD_BARS[name]; the launches of the kernel run counted."""
    atol, rtol = GRAD_BARS[name]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def run(f):
        leaves = [a.detach().requires_grad_(i in wrt) if isinstance(a, torch.Tensor) else a
                  for i, a in enumerate(args)]
        out = f(*leaves)
        return out, leaves

    reset_launches()
    out, leaves = run(fn)
    g = torch.randn(out.shape, generator=gen, device="cuda")
    got = torch.autograd.grad(out, [leaves[i] for i in wrt], g)
    torch.cuda.synchronize()
    launches = {n: WRAPPERS[n].launches for n in ("attention", "attention_bwd", "mlp_tail",
                                                  "block")}
    ref_out, ref_leaves = run(plain)
    ref = torch.autograd.grad(ref_out, [ref_leaves[i] for i in wrt], g)
    out_err = _max_err(out, ref_out)
    out_bar = FP32_ATOL[name] + FP32_RTOL[name] * float(ref_out.abs().max())
    shares = [float(((a - b).abs() / (atol + rtol * b.abs())).max()) for a, b in zip(got, ref)]
    errs = [_max_err(a, b) for a, b in zip(got, ref)]
    log(f"  5b(a) {tag}: {name} out max|Δ| {out_err:.3g} (bar {out_bar:.3g}); gradients of "
        f"{len(wrt)} inputs max|Δ| {max(errs):.3g}, worst share of the bar (atol {atol}, rtol "
        f"{rtol}) {max(shares):.3g}; launches {launches}")
    assert out_err <= out_bar, (tag, out_err, out_bar)
    assert max(shares) <= 1.0, (tag, shares)
    return {"case": tag, "kernel": name, "out_max_abs_err": out_err,
            "grad_max_abs_err": errs, "bar_share": shares, "launches": launches}


def kernel_grads_check() -> dict:
    """5b(a): K1 (a v4 site unmasked: K1 forward, B8 backward; the spatial
    fusion's masked shape: K1 forward, the plain recompute backward), K2 (a
    v4 site and the first dim-change site) and B3 (v0) under autograd on the
    card through ``ka.fused_attention``, ``kb.fused_mlp_tail`` and
    ``kb.fused_block``, at batch GRAD_BATCH in fp32 (TF32 off), against
    autograd of their plain twins; then B4, B5, the eval K3 and B9a refuse
    an input that wants a gradient ("inference-only", as in JAX)."""
    spec = build_spec(flagship_train_cfg())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    b = GRAD_BATCH
    rows = []

    thw, v4 = _video_site(spec, 4)
    lk = tmvit._lk(v4, thw)
    n, hd, lq = v4.num_heads, v4.head_dim, int(np.prod(thw))
    qkv = [torch.randn(b, n, length, hd, generator=gen, device="cuda")
           for length in (lq, lk, lk)]
    rows.append(_grad_case("v4 K1 unmasked", "attention", ka.fused_attention,
                           ka.fused_attention_plain, qkv + [v4.scale], [0, 1, 2]))
    assert rows[-1]["launches"]["attention"] == 1 and rows[-1]["launches"]["attention_bwd"] == 1
    sf, (t, h, w) = spec.spatial_fusion, spec.fusion_thw
    length = t * h * w + t
    mask = torch.from_numpy(tmvit.build_inframe_mask(spec.fusion_thw, t)).cuda()
    qkv = [torch.randn(b, sf.num_heads, length, sf.head_dim, generator=gen, device="cuda")
           for _ in range(3)]
    rows.append(_grad_case("spatial fusion K1 masked", "attention", ka.fused_attention,
                           ka.fused_attention_plain, qkv + [sf.scale, mask], [0, 1, 2]))
    assert rows[-1]["launches"]["attention"] == 1 and rows[-1]["launches"]["attention_bwd"] == 0

    change = next(i for i, blk in enumerate(spec.video_blocks) if blk.dim != blk.dim_out)
    for tag, i in (("v4", 4), (f"v{change} dim change", change)):
        thw, blk = _video_site(spec, i)
        x = torch.randn(b, int(np.prod(tmvit._static_pool_out(
            thw, blk.kernel_q, blk.stride_q, blk.padding_q)) if blk.pool_q_on else np.prod(thw)),
            blk.dim, generator=gen, device="cuda")
        args = [x] + _tail_weights(gen, blk.dim, blk.dim_out, blk.hidden_dim)
        wrt = [j for j, a in enumerate(args) if a is not None]
        rows.append(_grad_case(f"{tag} K2", "mlp_tail", kb.fused_mlp_tail,
                               kb.fused_mlp_tail_plain, args, wrt))
        assert rows[-1]["launches"]["mlp_tail"] == 1

    thw, v0 = _video_site(spec, 0)
    assert tmvit.block_route(v0, None, thw) == "block", "v0 is not on B3's route"
    lk = tmvit._lk(v0, thw)
    x = torch.randn(b, int(np.prod(thw)), v0.dim, generator=gen, device="cuda")
    kv = [torch.randn(b, v0.num_heads, lk, v0.head_dim, generator=gen, device="cuda")
          for _ in range(2)]
    ln1 = [1 + 0.1 * torch.randn(v0.dim, generator=gen, device="cuda"),
           0.1 * torch.randn(v0.dim, generator=gen, device="cuda")]
    args = ([x] + kv + [v0.scale] + ln1 + list(_linear(gen, v0.dim, v0.dim))
            + list(_linear(gen, v0.dim, v0.dim))
            + _tail_weights(gen, v0.dim, v0.dim_out, v0.hidden_dim))
    wrt = [j for j, a in enumerate(args) if isinstance(a, torch.Tensor)]
    rows.append(_grad_case("v0 B3", "block", kb.fused_block, kb.fused_block_plain, args, wrt))
    assert rows[-1]["launches"]["block"] == 1

    # the kernels without a backward refuse a gradient on the card, as in JAX
    z = torch.zeros(1, 8, 16, device="cuda", requires_grad=True)
    refused = {}
    for name, call in (("pool_block", lambda: kb.fused_pool_block(z, (1, 2, 4), z, z, z, 1.0, z,
                                                                  z, z, z, z)),
                       ("decoder_block", lambda: kb.fused_decoder_block(
                           z, (1, 2, 4), (1, 2, 2), z, z, z, 1.0, z, z, z, z, z)),
                       ("t2_upsample", lambda: kup.t2_upsample(z, (2, 2, 2))),
                       ("hw2_upsample", lambda: kup.hw2_upsample(z, (2, 2, 2)))):
        try:
            call()
            refused[name] = "no refusal"
        except RuntimeError as e:
            refused[name] = str(e)
    log("  5b(a) refusals under autograd: " + "; ".join(f"{k}: {v[:60]}"
                                                    for k, v in refused.items()))
    assert all("inference-only" in v for v in refused.values()), refused
    torch.cuda.empty_cache()
    return {"cases": rows, "refused": refused}


def switch_ab(rng: np.random.Generator) -> dict:
    """5b(c): the flagship's bf16 training step at batch 8 (``flagship_train_cfg``)
    on each of the JAX package's four training routes (SWITCH_ROUTES), in
    turns over SWITCH_AB_ROUNDS rounds of SWITCH_AB_STEPS steps: ms/step by
    CUDA events (median), the device's busy ms of one traced step
    (``device_trace``: the union of its activities), peak memory of one step,
    each route's launches a step against ``train_plan``."""
    cfg = flagship_train_cfg()
    spec = build_spec(cfg)
    bsz = cfg.TRAIN.BATCH_SIZE
    state = train_lib.create_train_state(cfg, spec, torch.Generator().manual_seed(SEED),
                                         device="cuda")
    batch = make_train_batch(rng, bsz, spec)
    step = train_lib.make_train_step(cfg, spec, steps_per_epoch=STEPS_PER_EPOCH)
    gen = torch.Generator().manual_seed(SEED + 3)
    res = {tag: {"steps_ms": []} for tag, _ in SWITCH_ROUTES}
    for tag, switches in SWITCH_ROUTES:
        with train_switches(**switches):
            plan = train_plan(state.model)
            reset_launches()
            step(state, batch, gen)
            torch.cuda.synchronize()
            launches = {name: WRAPPERS[name].launches for name in PER_STEP}
            assert launches == plan, f"{tag}: launches {launches}, plan {plan}"
            torch.cuda.reset_peak_memory_stats()
            step(state, batch, gen)
            torch.cuda.synchronize()
            res[tag].update(launches=launches, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    for _ in range(SWITCH_AB_ROUNDS):
        for tag, switches in SWITCH_ROUTES:
            with train_switches(**switches):
                res[tag]["steps_ms"] += [ms for ms, _ in timed_steps(step, state, batch, gen,
                                                                     SWITCH_AB_STEPS)]
    for tag, switches in SWITCH_ROUTES:
        with train_switches(**switches):
            wall, busy, _, n = device_trace(lambda: step(state, batch, gen))
        r = res[tag]
        r.update(median_ms=float(np.median(r["steps_ms"])), device_busy_ms=busy,
                 traced_wall_ms=wall, device_activities=n,
                 clips_per_s=bsz * 1e3 / float(np.median(r["steps_ms"])))
        log(f"  5b(c) {tag}: median {r['median_ms']:.2f} ms/step "
            f"({', '.join(f'{x:.1f}' for x in r['steps_ms'])}) = {r['clips_per_s']:.2f} train "
            f"clips/s, device busy {busy:.2f} ms of a traced step ({n} activities, wall "
            f"{wall:.2f} ms), peak memory {r['peak_gib']:.2f} GiB; launches a step "
            f"{ {k: v for k, v in r['launches'].items() if v} } ({CARD})")
    del state, batch
    torch.cuda.empty_cache()
    return res


def switches_phase(rng: np.random.Generator, steps: "dict | None" = None) -> dict:
    """Phase 5b: the JAX package's kernel switches at the flagship's width
    (TF32 off for fp32): (a) ``kernel_grads_check``; (b) phase 6b's fp32
    step at batch 2 (the same weights, masks and batch) under TRAIN_DECODER
    on and under TRAIN_ATTN off against the same step through the plain
    twins at the whole-step bars, launches against ``train_plan``
    (``whole_step_check``, run with phase 6b's: ``steps`` is its result;
    ``--switches`` runs it here); (c) ``switch_ab``."""
    out = {"grads": kernel_grads_check()}
    out["steps"] = steps if steps is not None else whole_step_check(rng, SWITCH_STEP_COMBOS)
    out["ab"] = switch_ab(rng)
    return out


def switch_launches(switches: dict, name: str) -> dict:
    """A kernel's launches a training step in phase 5b(b), under TRAIN_DECODER
    on and under TRAIN_ATTN off (the kernels line's keys)."""
    steps = switches["steps"]
    return {"launches_train_decoder": steps["train_decoder"]["launches"].get(name, 0),
            "launches_train_attn_off": steps["train_attn_off"]["launches"].get(name, 0)}


def _primary_counts(counts: dict) -> dict:
    """{wrapper: its primary kernel's launches} from by-name device counts."""
    return {name: sum(c for k, c in counts.items() if any(p in k.lower() for p in keys))
            for name, keys in PRIMARY_KERNEL.items()}


def _ours(counts: dict) -> dict:
    """The by-name counts of the port's kernels (the families of the seven
    eval kernels), without library kernels and copies."""
    return {k: c for k, c in counts.items()
            if any(p in k.lower() for keys in PRIMARY_KERNEL.values() for p in keys)
            or family(k) in KERNEL_FAMILIES}


def window_counts(fn) -> tuple:
    """(both windows' counts, the counts): one call of ``fn`` traced in each
    of two profiler windows, by device activity name; the two must agree.
    A call made as its window opened lost its first kernels now and then
    (``python -m csts_torch.tools.profile_forward --windows N`` counts how
    often), so ``kernel_counts`` makes each call
    ``profile_forward.WINDOW_MARGIN_S`` into its window, and no difference
    is let pass."""
    windows = [kernel_counts(fn) for _ in range(2)]
    diff = {k: windows[0].get(k, 0) - windows[1].get(k, 0)
            for k in windows[0].keys() | windows[1].keys()}
    assert windows[0] == windows[1], ("two windows of one call differ",
                                      {k: d for k, d in diff.items() if d})
    return windows, windows[0]


def _golden(got: np.ndarray, want: np.ndarray) -> dict:
    """tests/test_golden_256.py's bar on two heatmap stacks (B, T, h, w)."""
    res = softmax_check(torch.from_numpy(got), torch.from_numpy(want))
    res["ok"] = res["softmax_max_abs_diff"] < 0.02 and res["argmax_off_on_decided"] == 0
    return res


def latency_phase(pred, spec, rng) -> dict:
    """Requests of 1, 5 and 8 clips from host memory through ``predict`` (a
    graph replay each), LATENCY_REQUESTS of each after LATENCY_WARMUP: the
    median and p90 request ms, the replay's device time and the host's share
    (request wall - replay device time)."""
    rows = {}
    replay_dev = {b: device_ms(lambda b=b: pred._slots[b].graph.replay(), calls=20)
                  for b in pred.batch_sizes}
    for n in REQUESTS:
        video, audio = make_inputs(rng, n, spec)
        for _ in range(LATENCY_WARMUP):
            pred.predict(video, audio)
        ms = []
        for _ in range(LATENCY_REQUESTS):
            t0 = time.perf_counter()
            pred.predict(video, audio)
            ms.append((time.perf_counter() - t0) * 1e3)
        ms.sort()
        b = pred._bucket(n)
        med = ms[len(ms) // 2]
        dev = replay_dev[b]
        rows[n] = {"bucket": b, "requests": len(ms), "median_ms": med,
                   "p90_ms": ms[min(len(ms) - 1, int(len(ms) * 0.9))],
                   "replay_device_ms": dev, "host_ms": None if dev is None else med - dev,
                   "host_share": None if dev is None else 1 - dev / med}
        log(f"  latency {n} clips (bucket {b}): median {med:.2f} ms, p90 {rows[n]['p90_ms']:.2f} "
            f"ms over {len(ms)} requests; replay device {_ms(dev)} ms, host "
            f"{_ms(rows[n]['host_ms'])} ms = share {rows[n]['host_share']} ({CARD})")
    return rows


def export_phase(pred, requests, outs) -> dict:
    """``export_compiled`` on the card for buckets (1, 8) into a temporary
    directory, ``from_exported``, and the artifact's predictor through the
    kernels (launch counts of its first, eager, request), its capture and a
    replay, each held against the live predictor's answer: bit-equal, or
    else within the golden bar."""
    res = {}
    with tempfile.TemporaryDirectory() as art:
        t0 = time.perf_counter()
        pred.export_compiled(art, batch_sizes=(1, 8))
        res["export_s"] = time.perf_counter() - t0
        res["files_mb"] = {f: os.path.getsize(os.path.join(art, f)) / 1e6
                           for f in sorted(os.listdir(art))}
        t0 = time.perf_counter()
        exp = GazePredictor.from_exported(art)
        res["load_s"] = time.perf_counter() - t0
    video, audio = requests[-1]
    res["runs"] = []
    for run in ("eager", "capture", "replay"):
        reset_launches()
        got = exp.predict(video, audio)
        count = {name: WRAPPERS[name].launches for name in PER_FORWARD}
        if run != "replay":
            for name, per in PER_FORWARD.items():
                assert count[name] == per, (run, name, count[name], per)
        equal = bool(np.array_equal(got["heatmaps"], outs[-1]["heatmaps"]))
        check = _golden(got["heatmaps"], outs[-1]["heatmaps"])
        assert equal or check["ok"], (run, check)
        assert np.array_equal(got["gaze_xy"], outs[-1]["gaze_xy"]) or check["ok"]
        res["runs"].append({"run": run, "launches": count, "bit_equal": equal,
                            "max_abs_diff": float(np.abs(got["heatmaps"]
                                                         - outs[-1]["heatmaps"]).max())})
    del exp
    torch.cuda.empty_cache()
    log(f"  export: buckets (1, 8) in {res['export_s']:.2f} s, files "
        + ", ".join(f"{f} {mb:.1f} MB" for f, mb in res["files_mb"].items())
        + f"; from_exported {res['load_s']:.2f} s; "
        + "; ".join(f"{r['run']}: launches {sum(r['launches'].values())}, bit-equal "
                    f"{r['bit_equal']} (max|Δ| {r['max_abs_diff']:.3g})" for r in res["runs"]))
    return res


def service_phase(pred, spec, rng) -> dict:
    """A loopback GazeHTTPServer over the live predictor: SERVICE_CLIENTS
    threads post SERVICE_POSTS one-clip requests each (two of them raw
    uint8 frames at SERVICE_RAW); clips/s, client-side p50/p99, the
    batcher's occupancy; every answer within the golden bar of a direct
    predict of the same clip."""
    import io

    t, s = spec.num_frames, spec.crop_size
    clips = [tuple(x[0] for x in make_inputs(rng, 1, spec)) for _ in range(SERVICE_CLIPS)]
    raw = rng.integers(0, 256, (t, *SERVICE_RAW, 3), dtype=np.uint8)
    bodies = []
    for i in range(SERVICE_CLIENTS * SERVICE_POSTS):
        buf = io.BytesIO()
        video, audio = clips[i % SERVICE_CLIPS]
        np.savez(buf, video=raw if i in (5, 37) else video, audio=audio)
        bodies.append(buf.getvalue())
    answers, lat = [None] * len(bodies), [0.0] * len(bodies)
    server = GazeHTTPServer(pred, port=0, max_wait_ms=5.0).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        assert urllib.request.urlopen(f"{base}/healthz", timeout=30).read() == b"ok"

        def client(c):
            for i in range(c * SERVICE_POSTS, (c + 1) * SERVICE_POSTS):
                req = urllib.request.Request(f"{base}/predict", data=bodies[i], method="POST")
                t0 = time.perf_counter()
                blob = urllib.request.urlopen(req, timeout=300).read()
                lat[i] = (time.perf_counter() - t0) * 1e3
                answers[i] = np.load(io.BytesIO(blob))["heatmaps"]

        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVICE_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        stats = json.loads(urllib.request.urlopen(f"{base}/stats", timeout=30).read())
    finally:
        server.close()
    assert all(a is not None for a in answers) and stats["errors"] == 0, stats
    direct = [pred.predict(v[None], a[None])["heatmaps"][0] for v, a in clips]
    direct_raw = pred.predict(pred.preprocess_frames(raw)[None], clips[5 % SERVICE_CLIPS][1][None])
    worst = {"softmax_max_abs_diff": 0.0, "argmax_off_on_decided": 0, "decided_frames": 0}
    for i, got in enumerate(answers):
        want = direct_raw["heatmaps"][0] if i in (5, 37) else direct[i % SERVICE_CLIPS]
        check = _golden(got[None], want[None])
        assert check["ok"], (i, check)
        worst["softmax_max_abs_diff"] = max(worst["softmax_max_abs_diff"],
                                            check["softmax_max_abs_diff"])
        worst["argmax_off_on_decided"] += check["argmax_off_on_decided"]
        worst["decided_frames"] += check["decided_frames"]
    lat.sort()
    res = {"requests": len(bodies), "wall_s": wall, "clips_per_s": len(bodies) / wall,
           "p50_ms": lat[len(lat) // 2], "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
           "occupancy": stats["mean_batch_occupancy"], "batches": stats["batches"],
           "server_p50_ms": stats.get("latency_p50_ms"),
           "server_p99_ms": stats.get("latency_p99_ms"), "vs_direct": worst}
    log(f"  service: {len(bodies)} requests from {SERVICE_CLIENTS} clients in {wall:.2f} s = "
        f"{res['clips_per_s']:.2f} clips/s, client p50 {res['p50_ms']:.1f} ms p99 "
        f"{res['p99_ms']:.1f} ms, {stats['batches']} batches, mean occupancy "
        f"{res['occupancy']:.2f}; vs direct predict: softmax max|Δ| "
        f"{worst['softmax_max_abs_diff']:.3g}, argmax off on {worst['argmax_off_on_decided']} "
        f"of {worst['decided_frames']} decided frames ({CARD})")
    return res


def switches(conf: str):
    """``ab_flags.flags`` over the defaults: "base" is JAX's default switches
    (head_commute and t2_skip on), another name is switched on beside them."""
    on = "head_commute+t2_skip"
    return ab_flags.flags(on if conf == "base" else f"{on}+{conf}")


def stale_graph_phase(pred, requests) -> dict:
    """``hw2_skip`` flipped after bucket 8's capture: the next request must
    not replay the stale graph (B9a launches 2 there), the one after it
    captures (2 again), the third replays, with B9a's kernel in the
    replay's device kernels."""
    video, audio = requests[-1]
    assert pred._slots[8].graph is not None
    res = {}
    with switches("hw2_skip"):
        for run in ("next", "capture"):
            reset_launches()
            pred.predict(video, audio)
            res[run] = WRAPPERS["hw2_upsample"].launches
        slot = pred._slots[8]
        counts = kernel_counts(lambda: slot.graph.replay())
        res["replay_hw2_kernels"] = _primary_counts(counts)["hw2_upsample"]
    assert res["next"] == HW2_PER_FORWARD and res["capture"] == HW2_PER_FORWARD, res
    assert res["replay_hw2_kernels"] == HW2_PER_FORWARD, res
    pred.predict(video, audio)  # off again: the bucket warms up anew
    log(f"  stale graph: hw2_skip flipped after the capture: B9a launches "
        f"{res['next']} on the next request (a stale replay would give 0), {res['capture']} "
        f"at the re-capture, {res['replay_hw2_kernels']} B9a kernels in its replay")
    return res


def serve_phase(pred, spec, rng, requests, outs) -> dict:
    """The graphs against the eager forward (bit-equal at each bucket, and
    the same device kernels by name in a replay as in the eager forward),
    the request latency, the artifact exported on the card, the HTTP service
    and a switch flipped after a capture."""
    res = {"graphs": {}}
    for b in pred.batch_sizes:
        video, audio = make_inputs(rng, b, spec)
        v, a = torch.from_numpy(video).cuda(), torch.from_numpy(audio).cuda()
        graph = pred.serve(v, a).clone()
        slot = pred._slots[b]
        assert slot.graph is not None
        eager = pred.forward(v, a)
        equal = bool(torch.equal(graph, eager))
        reset_launches()
        eager_windows, eager_counts = window_counts(lambda: pred.forward(v, a))
        eager_launches = {n: WRAPPERS[n].launches for n in PER_FORWARD}
        replay_windows, replay_counts = window_counts(lambda: slot.graph.replay())
        eager_counts, replay_counts = _ours(eager_counts), _ours(replay_counts)
        primary = _primary_counts(replay_counts)
        res["graphs"][b] = {"bit_equal": equal,
                            "max_abs_diff": float((graph - eager).abs().max()),
                            "replay_primary": primary, "eager_primary": _primary_counts(eager_counts),
                            "same_kernels": replay_counts == eager_counts,
                            "eager_windows": eager_windows, "replay_windows": replay_windows,
                            "eager_launches_two_calls": eager_launches}
        # the wrappers launched every kernel in both eager calls, whatever
        # the profiler saw
        assert eager_launches == {n: 2 * c for n, c in PER_FORWARD.items()}, eager_launches
        log(f"  graph bucket {b}: replay vs eager forward bit-equal {equal}; kernels by name in "
            f"one replay {primary} (eager {_primary_counts(eager_counts)}), the same "
            f"{len(replay_counts)} names and counts as the eager forward: "
            f"{replay_counts == eager_counts}; two windows agreed: eager "
            f"{eager_windows[0] == eager_windows[1]}, replay "
            f"{replay_windows[0] == replay_windows[1]}")
        assert equal, res["graphs"][b]
        assert replay_counts == eager_counts, (replay_counts, eager_counts)
        for name, per in PER_FORWARD.items():
            assert primary[name] == per, (b, name, primary[name], per)
        del v, a, graph, eager
    res["latency"] = latency_phase(pred, spec, rng)
    res["export"] = export_phase(pred, requests, outs)
    res["service"] = service_phase(pred, spec, rng)
    res["stale_graph"] = stale_graph_phase(pred, requests)
    return res


def dispatch_ab(pred, rng, spec) -> dict:
    """The eager forward at batches 8 and 1 (where the host paces it) with
    the kernels called through their custom ops (as shipped) and through
    their launches directly (as before the ops), DISPATCH_TURNS turns each
    in alternation, CUDA events."""
    res = {}
    for b in (8, 1):
        v, a = (torch.from_numpy(x).cuda() for x in make_inputs(rng, b, spec))
        runs = res[b] = {"ops": [], "direct": []}
        with torch.inference_mode():
            for _ in range(DISPATCH_TURNS):
                runs["ops"].append(time_ms(lambda: pred.forward(v, a), target_s=0.5))
                with direct_launches():
                    runs["direct"].append(time_ms(lambda: pred.forward(v, a), target_s=0.5))
        log(f"  dispatch: eager forward batch {b} through the ops "
            + ", ".join(f"{t:.3f}" for t in runs["ops"]) + " ms; direct launches "
            + ", ".join(f"{t:.3f}" for t in runs["direct"]) + f" ms ({CARD})")
    return res


def hw2_phase(pred, v, a) -> dict:
    """Phase 4b: B9a behind ab_flags' hw2_skip switch, under the serving
    predictor at batch 8: launches with the switch on and off, B9a against
    its plain version at d2's and d3's shapes, the forward timed on and off
    in turns, and the two forwards' outputs compared. The switch is restored
    on the way out (``ab_flags.flags``)."""
    counts = {}
    for conf in ("hw2_skip", "base"):
        with switches(conf), torch.inference_mode():
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
    with switches("hw2_skip"), recording(calls), torch.inference_mode():
        pred.forward(v, a)
    torch.cuda.synchronize()
    with torch.inference_mode():
        rows = check_kernels({8: calls}, B9_KERNELS)["hw2_upsample"]["shapes"]
    assert sum(r["launches_per_forward"] for r in rows) == HW2_PER_FORWARD, rows

    # the forward with the switch on and off, in turns
    turns = {"hw2_skip": [], "base": []}
    with torch.inference_mode():
        for conf in ("base", "hw2_skip", "hw2_skip", "base") * 3:
            with switches(conf):
                turns[conf].append(time_ms(lambda: pred.forward(v, a), target_s=0.3))
        logits = {}
        for conf in ("hw2_skip", "base"):
            with switches(conf):
                logits[conf] = pred.model(v, a).float()
        busy = {}
        for conf in ("hw2_skip", "base"):
            with switches(conf):
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
# 7c: the trainer through TRAIN.CHECKPOINT_BACKEND "orbax", a save each epoch
ORBAX_ARGS = ["TRAIN.CHECKPOINT_BACKEND", "orbax", "TRAIN.CHECKPOINT_PERIOD", "1"]
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
    """run_net's arguments: the yaml and what this phase sets over it (one
    rank: the yaml's NUM_DEVICES is the reference's 4 GPUs). The run that
    tests saves its final epoch; the drill's runs save only the preemption's
    npz (their final states are compared in memory)."""
    prefix, splits = split
    return ["--cfg", YAML, "NUM_DEVICES", "1",
            "DATA.PATH_PREFIX", prefix, "DATA.PATH_TO_DATA_DIR", splits,
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


TB_TAGS = {"Train/loss", "Train/lr", "Train/F1", "Train/Recall", "Train/Precision"}


def _tensorboard_records(log_dir: str) -> dict:
    """What TENSORBOARD.ENABLE wrote: the JSONL records (no tensorboard
    package: their count, steps and tags), or the event files."""
    files = sorted(os.listdir(log_dir))
    if "scalars.jsonl" not in files:
        assert any(f.startswith("events") for f in files), files
        return {"route": "SummaryWriter", "files": files}
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    tags = sorted(set().union(*(r.keys() for r in recs)) - {"step", "ts"})
    assert len(recs) == TRAINER_EPOCHS * (TRAINER_TRAIN_ROWS // 8), len(recs)
    assert [r["step"] for r in recs] == list(range(len(recs))), recs
    assert TB_TAGS <= set(tags) and all(np.isfinite(r["Train/loss"]) for r in recs), tags
    return {"route": "scalars.jsonl", "records": len(recs), "tags": tags,
            "loss_first_last": [recs[0]["Train/loss"], recs[-1]["Train/loss"]]}


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
        # the consumer's waits inside training epochs, the saves and loads,
        # the orbax backend's saves (7c) and the times their steps committed
        seen = {"steps": [], "waits": [], "epochs": [], "saves": [], "loads": [], "in_train": False,
                "orbax": [], "commits": {}}
        make_step, next_batch = train_lib.make_train_step, loader_lib.DevicePrefetcher.__next__
        train_epoch, save, load = trainer_lib._train_epoch, cu.save_checkpoint, cu.load_checkpoint
        load_params, train_fn = cu.load_params_npz, trainer_lib.train
        ck_save, ck_commit = orbax_ckpt.OrbaxCheckpointer.save, orbax_ckpt.OrbaxCheckpointer._commit

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

        def timed_ck_save(self, state, step):
            t = time.perf_counter()
            self.wait()  # the previous save, which ``save`` would wait for first
            t0 = time.perf_counter()
            ck_save(self, state, step)
            seen["orbax"].append({"step": step, "dir": self.step_dir(step), "t0": t0,
                                  "previous_s": t0 - t,
                                  "blocked_s": time.perf_counter() - t0, **self.last_save})

        def timed_commit(self, step, future):
            ck_commit(self, step, future)
            seen["commits"].setdefault(self.step_dir(step), time.perf_counter())

        def measured_train(cfg, device=None):
            torch.cuda.reset_peak_memory_stats()
            state = train_fn(cfg, device)
            seen["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            seen["final"] = cu.state_leaves(state)  # the JAX layout, on the host
            seen["state"] = state
            return state

        runs = {}
        try:
            train_lib.make_train_step = recording_step
            loader_lib.DevicePrefetcher.__next__ = timed_next
            trainer_lib._train_epoch = timed_epoch
            cu.save_checkpoint, cu.load_checkpoint = timed_save, timed(load, "loads")
            cu.load_params_npz = timed(load_params, "loads")
            trainer_lib.train = measured_train
            orbax_ckpt.OrbaxCheckpointer.save = timed_ck_save
            orbax_ckpt.OrbaxCheckpointer._commit = timed_commit
            # the run: train, then test the npz it wrote (the yaml's 8 workers)
            a_out = os.path.join(root, "run_a")
            reset_launches()
            t = time.perf_counter()
            stats = run_net.main(_run_net_args(split, pyths, a_out, 8, True))
            out["run_s"] = time.perf_counter() - t
            launches = {name: WRAPPERS[name].launches for name in COUNTED}
            runs["a"] = {k: list(v) if isinstance(v, list) else v for k, v in seen.items()}
            seen.pop("state")
            for key in ("steps", "waits", "epochs"):
                seen[key] = []
            # a second uninterrupted run: the spread between two runs; it also
            # writes rank 0's TENSORBOARD.ENABLE scalars (11d) and, through the
            # orbax backend, an async checkpoint each epoch (7c: steps 6, 12)
            b_out = os.path.join(root, "run_b")
            run_net.main(_run_net_args(split, pyths, b_out, DRILL_WORKERS, False)
                         + ["TENSORBOARD.ENABLE", "True"] + ORBAX_ARGS)
            runs["b"] = seen.pop("final")
            runs["b_steps"] = [(t, st.elapsed_time(en)) for t, st, en, _ in seen["steps"]]
            seen.pop("state")
            out["tensorboard"] = _tensorboard_records(os.path.join(b_out, "runs-csts"))
            # the drill: SIGTERM injected mid-epoch, then auto-resume to the end
            c_out = os.path.join(root, "run_c")
            trainer_lib._PREEMPT_AFTER_ITERS = PREEMPT_AFTER
            try:
                run_net.main(_run_net_args(split, pyths, c_out, DRILL_WORKERS, False))
            finally:
                trainer_lib._PREEMPT_AFTER_ITERS = None
            seen.pop("state")
            mid = cu.get_last_checkpoint(c_out)
            mid_meta = cu.checkpoint_meta(mid)
            run_net.main(_run_net_args(split, pyths, c_out, DRILL_WORKERS, False))
            runs["c"] = seen.pop("final")
            seen.pop("state")
            assert cu.get_last_checkpoint(c_out) == mid  # the drill's runs save nothing else
            # 7c's drill: run b's step 6 resumed, SIGTERM injected after 3
            # iterations of epoch 2 (step 9), resumed again to step 12; no
            # validation in these two runs (it moves no state)
            d_out = os.path.join(root, "run_d")
            shutil.copytree(os.path.join(b_out, orbax_ckpt.CHECKPOINT_DIR, "6"),
                            os.path.join(d_out, orbax_ckpt.CHECKPOINT_DIR, "6"))
            d_args = (_run_net_args(split, pyths, d_out, DRILL_WORKERS, False) + ORBAX_ARGS
                      + ["TRAIN.EVAL_PERIOD", str(TRAINER_EPOCHS + 1)])
            trainer_lib._PREEMPT_AFTER_ITERS = PREEMPT_AFTER
            try:
                run_net.main(d_args)
            finally:
                trainer_lib._PREEMPT_AFTER_ITERS = None
            seen.pop("state")
            runs["d_mid"] = orbax_ckpt.committed_steps(d_out)
            run_net.main(d_args)
            runs["d"] = seen.pop("final")
            runs["d_steps"] = orbax_ckpt.committed_steps(d_out)
            runs["d_state"] = seen.pop("state")
        finally:
            train_lib.make_train_step, loader_lib.DevicePrefetcher.__next__ = make_step, next_batch
            trainer_lib._train_epoch, trainer_lib.train = train_epoch, train_fn
            cu.save_checkpoint, cu.load_checkpoint, cu.load_params_npz = save, load, load_params
            orbax_ckpt.OrbaxCheckpointer.save = ck_save
            orbax_ckpt.OrbaxCheckpointer._commit = ck_commit

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
        spread = _diff(ga, _groups(runs["b"], p))
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
        for g in drill:
            # training is deterministic on the card (the max-pool backward in a
            # fixed order, ops.max_pool3d): two runs agree bit for bit, and so
            # must the drill, resumed from its mid-epoch npz
            assert spread[g]["max"] == 0.0, ("two uninterrupted runs differ", g, spread[g])
            assert drill[g]["max"] == 0.0, ("the drill differs from the run", g, drill[g])
        out["orbax"] = orbax_checks(root, seen, runs, b_out, p)
        del ga, final_a, runs
    torch.cuda.empty_cache()
    out.update(trainer_extras(rng))
    return out


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path))


def orbax_checks(root: str, seen: dict, runs: dict, b_out: str, p: int) -> dict:
    """7c (a), TRAIN.CHECKPOINT_BACKEND "orbax" in one process: run b's two
    async saves (steps 6 and 12: the seconds the trainer was blocked in
    ``save``, the seconds until the step committed, the bytes on disk, the
    steps that ran while it was written); the drill (run b's step 6 resumed,
    stopped at step 9, resumed to step 12) bit-equal to the run; step 12
    restored into the drill's final state, every value of it spoiled first,
    equal to run b's ``state_leaves`` leaf for leaf; the npz save of that
    same state timed beside the orbax figures."""
    out: dict = {"saves": []}
    steps = runs.pop("b_steps")
    saves = [r for r in seen["orbax"] if r["dir"].startswith(b_out)]
    assert [r["step"] for r in saves] == [TRAINER_TRAIN_ROWS // 8 * (e + 1)
                                         for e in range(TRAINER_EPOCHS)], saves
    for r in saves:
        commit_s = seen["commits"][r["dir"]] - r["t0"]
        over = [ms for t, ms in steps if r["t0"] <= t < seen["commits"][r["dir"]]]
        rest = [ms for t, ms in steps if not r["t0"] <= t < seen["commits"][r["dir"]]]
        row = {"step": r["step"], "blocked_s": r["blocked_s"], "previous_s": r["previous_s"],
               "commit_s": commit_s,
               "staged_bytes": r["bytes"], "pieces": r["pieces"],
               "disk_bytes": _dir_bytes(r["dir"]), "files": sorted(os.listdir(r["dir"])),
               "overlapped_steps_ms": over, "other_steps_ms": rest}
        out["saves"].append(row)
        log(f"phase trainer 7c run b save of step {r['step']}: blocked {r['blocked_s']:.3f} s "
            f"(staged {r['bytes'] / 1e9:.3f} GB in {r['pieces']} pieces to pinned host memory; "
            f"before it, {r['previous_s']:.3f} s waiting for the previous save to commit), "
            f"committed {commit_s:.3f} s after the save began, {row['disk_bytes'] / 1e9:.3f} GB "
            f"on disk ({row['files']}); steps that ran during the write: {len(over)}"
            + (f" (median {np.median(over):.2f} ms)" if over else "")
            + f", the run's other steps median {np.median(rest):.2f} ms (CUDA events; {CARD})")
    want = runs.pop("b")
    assert runs["d_mid"] == [6, 9] and runs["d_steps"] == [6, 9, 12], (runs["d_mid"],
                                                                       runs["d_steps"])
    differ = [i for i, (a, b) in enumerate(zip(runs.pop("d"), want)) if not np.array_equal(a, b)]
    out["drill_leaves_differing"] = differ
    log(f"phase trainer 7c drill: run b's step 6 resumed, SIGTERM injected after "
        f"{PREEMPT_AFTER} iterations of epoch 2: committed {runs['d_mid']}, resumed to "
        f"{runs['d_steps']}; the final state against run b's: {len(differ)} of {len(want)} "
        f"leaves differ")
    assert not differ, ("the orbax drill differs from the run", differ[:5])

    # step 12 restored into the drill's final state with every value spoiled
    # (NaN, step and counts 0, lr NaN), then the npz of it
    state = runs.pop("d_state")
    with torch.no_grad():
        for loc in cu.local_state(state).values():
            for _, t in loc.pieces:
                t.fill_(float("nan") if t.is_floating_point() else 0)
    state.step = 0
    state.optimizer.set_count(0)
    state.optimizer.set_lr(float("nan"))
    ck = orbax_ckpt.OrbaxCheckpointer(b_out)
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, step = ck.restore(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    ck.close()
    leaves = cu.state_leaves(state)
    assert step == 12 and len(leaves) == len(want) == 3 * p + 4, (step, len(leaves))
    for i, (got, w) in enumerate(zip(leaves, want)):
        assert got.dtype == w.dtype and np.array_equal(got, w), ("restored leaf differs", i)
    t = time.perf_counter()
    npz = cu.save_checkpoint(os.path.join(root, "npz_same"), state, 1)
    npz_s = time.perf_counter() - t
    npz_gb = os.path.getsize(npz) / 1e9
    out.update(restore_s=restore_s, npz_save_s=npz_s, npz_gb=npz_gb, restored_leaves=len(leaves))
    log(f"phase trainer 7c restore: step 12 into a spoiled state in {restore_s:.3f} s, "
        f"state_leaves equal to run b's leaf for leaf ({len(leaves)} leaves); the npz save "
        f"of the same state {npz_s:.3f} s for {npz_gb:.3f} GB, against orbax's blocked "
        + " / ".join(f"{r['blocked_s']:.3f}" for r in out["saves"]) + " s and committed after "
        + " / ".join(f"{r['commit_s']:.3f}" for r in out["saves"]) + f" s ({CARD})")

    del state, leaves, want
    torch.cuda.empty_cache()
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

    pools = set()  # the skip pools' (shape, dtype, kernel, stride, padding) at batch 8
    skip_pool = tops.max_pool3d

    def recording_pool(x, *geom):
        pools.add((tuple(x.shape), x.dtype, *(tuple(int(v) for v in a) for a in geom)))
        return skip_pool(x, *geom)

    res = {}
    for turn in range(2):
        for tag, remat, accum, data in (("act_off", False, 1, half), ("act_on", True, 1, half),
                                        ("b16_accum1", False, 1, batch),
                                        ("b16_accum2", False, 2, batch)):
            tops.max_pool3d = recording_pool if (turn, tag) == (0, "act_off") else skip_pool
            ms, peak = measure(remat, accum, data)
            r = res.setdefault(tag, {"ms": [], "peak_gib": 0.0})
            r["ms"] += ms
            r["peak_gib"] = max(r["peak_gib"], peak)
    tops.max_pool3d = skip_pool
    for r in res.values():
        r["median_ms"] = float(np.median(r["ms"]))
    res["pool_backward"] = pool_backward_timing(sorted(pools, key=str))

    # fp32 gradients at batch 16: one pass against two micro-batches
    model.spec = dataclasses.replace(spec, dtype="float32", remat=False)
    gen2 = torch.Generator().manual_seed(SEED + 6)
    micro = [sample_drop_masks(spec.video_blocks, ACCUM_BATCH // 2, gen2, "cuda") for _ in range(2)]
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
    pb = res["pool_backward"]
    log(f"phase trainer max-pool backward (the encoder skips of one batch-8 step, in turns, "
        f"CUDA events; {CARD}): fixed order {sum(r['fixed_ms'] for r in pb):.3f} ms, CUDA's "
        f"atomics {sum(r['atomic_ms'] for r in pb):.3f} ms; "
        + "; ".join(f"{r['shape']} {r['fixed_ms']:.3f} vs {r['atomic_ms']:.3f} ms" for r in pb))
    assert dloss <= STEP_LOSS_RTOL, (loss1, loss2)
    assert worst[0][1] <= 1.0, worst
    model.spec = spec
    del state, model, batch, half, snapshot, g1, g2
    torch.cuda.empty_cache()
    return {"extras": res}


def pool_backward_timing(pools: list) -> list:
    """The max-pool backward training takes on the card (``ops.conv``'s fixed
    order) against CUDA's own (``max_pool3d_with_indices_backward``, atomics)
    at each recorded skip pool, from one set of indices, in turns (ABBA), by
    CUDA events; the fixed order's two results bit-equal and within a bf16
    rounding of CUDA's fp32 backward."""
    out = []
    for shape, dtype, kernel, stride, padding in pools:
        b, t, h, w, c = shape
        x = torch.randn((b, c, t, h, w), device="cuda").to(dtype)
        y, idx = F.max_pool3d(x, kernel, stride, padding, return_indices=True)
        g = torch.randn_like(y)
        fns = {"fixed": lambda: oc.max_pool3d_backward(g, idx, x.shape, kernel, stride, padding),
               "atomic": lambda: torch.ops.aten.max_pool3d_with_indices_backward(
                   g, x, kernel, stride, padding, (1, 1, 1), False, idx)}
        ms = {"fixed": [], "atomic": []}
        for name in ("atomic", "fixed", "fixed", "atomic"):
            ms[name].append(time_ms(fns[name]))
        one, two = fns["fixed"](), fns["fixed"]()
        assert torch.equal(one, two), shape
        # against CUDA's backward in fp32 (the bf16 one rounds every atomic
        # add): the fixed order's fp32 sums rounded once to bf16
        ref = torch.ops.aten.max_pool3d_with_indices_backward(
            g.float(), x.float(), kernel, stride, padding, (1, 1, 1), False, idx)
        err = float(((one.float() - ref).abs() / (1 + ref.abs())).max())
        assert err <= 2 ** -8, (shape, err)
        out.append({"shape": [b, t, h, w, c], "kernel": kernel, "stride": stride,
                    "fixed_ms": float(np.mean(ms["fixed"])),
                    "atomic_ms": float(np.mean(ms["atomic"])), "rel_err": err})
    return out


def determinism_probe(audit: "ProcessAudit") -> int:
    """``python3 chip_smoke.py --determinism``, a one-off beside the smoke:
    the kernel build, then phase 7 (``trainer_phase``) alone under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` (cuBLAS
    with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``), printing every op the mode
    names as having no deterministic implementation, and the phase's own
    lines (its two uninterrupted runs' difference among them). It prints no
    result line."""
    import warnings

    t0 = time.perf_counter()
    _build.build_all()
    log(f"phase build: {time.perf_counter() - t0:.2f} s")
    torch.use_deterministic_algorithms(True, warn_only=True)
    failure = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            trainer_phase(np.random.default_rng(SEED))
        except Exception as exc:  # noqa: BLE001 — the ops named so far still print
            failure = repr(exc)
    named = {}
    for w in caught:
        text = str(w.message)
        if "deterministic" in text:
            key = text.split(". ")[0]
            named[key] = named.get(key, 0) + 1
    log(f"determinism: {len(named)} ops named under use_deterministic_algorithms "
        f"(warn_only) in phase 7 ({CARD}):")
    for key, n in sorted(named.items()):
        log(f"  {n:6d} x {key}")
    log(f"determinism: phase 7 {'raised ' + failure if failure else 'ran to its end'}")
    close_run(audit)
    return 0



# --- phase 8: several processes ------------------------------------------------
#
# Two ranks share the one card over gloo (NCCL refuses two ranks on one
# device: tests/test_torch_cuda.py test_two_ranks_on_one_card_need_gloo).
# The kernels are built once, before any spawn; the ranks only load them.

PAR_WORLD = 2
PAR_BATCH = 2        # 8a/8b fp32 global batch: 1 a rank
PAR_TIMED_BATCH = 8  # 8a bf16 global batch: 4 a rank
PAR_TIMED_STEPS = 3
PAR_EVAL_CLIPS = 20  # 8c: 20 rows at one view, 40 at two
PAR_EVAL_BATCH = 6   # 3 a rank: at one view rank 1's stripe of the last batch is
                     # empty; at two views clips 1, 7, 13 and 19 straddle the stripes
PAR_TRAIN_KERNELS = ("attention", "attention_bwd", "mlp_tail_train", "t2_upsample")
# gloo takes the collectives DDP and ZeRO-1 use on CUDA tensors; FSDP's
# checkpoint gathers its shards with DTensor's full_tensor, a functional
# collective, which gloo cannot run on CUDA tensors (it crashes), so FSDP
# runs on the card under NCCL at world size 1 and its cross-rank parity is
# held on the CPU (tests/test_torch_parallel.py)
PAR_GLOO_MODES = ("ddp", "zero1")


def _par_cfg(mode: str = "ddp"):
    """8a/8b: the flagship from ``flagship_train_cfg`` in fp32 (TF32 off) at
    global batch 2, kldiv+egonce, drop-path 0.2."""
    cfg = flagship_train_cfg()
    cfg.TRAIN.MIXED_PRECISION = False
    cfg.TRAIN.BATCH_SIZE = PAR_BATCH
    cfg.SOLVER.ZERO1 = mode == "zero1"
    cfg.SOLVER.FSDP = mode == "fsdp"
    return cfg


def _par_batch(rng: np.random.Generator, n: int, spec) -> dict:
    """make_train_batch's batch on the host (each rank moves its rows)."""
    video, audio = make_inputs(rng, n, spec)
    hw = spec.crop_size // 4
    hm = rng.uniform(0.0, 1.0, (n, spec.num_frames, hw, hw)).astype(np.float32)
    hm /= hm.sum(axis=(2, 3), keepdims=True)
    return {k: torch.from_numpy(a) for k, a in (("video", video), ("audio", audio),
                                                 ("labels_hm", hm))}


def _two_steps(cfg, sd: dict, batch: dict, drops: list, device) -> tuple:
    """Two steps of ``make_train_step`` from ``sd`` on ``batch`` (this
    rank's rows) with the global batch's masks: (state, stats, every
    gradient after step 1 and the params after step 2, whole, on the host,
    launches a step of the training kernels)."""
    spec = build_spec(cfg)
    state = train_lib.create_train_state(cfg, spec, state_dict=sd, device=device)
    step = train_lib.make_train_step(cfg, spec, STEPS_PER_EPOCH)
    batch = {k: v.to(device) for k, v in batch.items()}
    reset_launches()
    stats = []
    for i, drop in enumerate(drops):
        drop = [None if m is None else tuple(x.to(device) for x in m) for m in drop]
        st, _ = step(state, batch, None, drop=drop)
        stats.append({k: float(v) for k, v in st.items()})
        if i == 0:
            grads = {n: collectives.whole(p.grad).detach().float().cpu()
                     for n, p in state.model.named_parameters()}
    launches = {n: WRAPPERS[n].launches / len(drops) for n in PAR_TRAIN_KERNELS}
    params = {n: collectives.whole(p.detach()).float().cpu()
              for n, p in state.model.named_parameters()}
    return state, stats, grads, params, launches


def _step_errors(stats, grads, params, ref: dict, lr_steps: float) -> dict:
    """Against ``ref`` at phase 6's whole-step bars: each step's loss within
    STEP_LOSS_RTOL relative; each gradient's share of its bar (relative norm
    STEP_GRAD_RTOL plus STEP_GRAD_FLOOR of the whole gradient's norm; fails
    above 1); the params within 2·Σlr elementwise (Adam's step is at most
    about lr in size on either side, where a gradient near its eps takes
    rounding noise to a whole step), with the largest difference and the
    count above 1e-6 reported."""
    norm = lambda t: float(torch.linalg.vector_norm(t))  # noqa: E731
    loss_rel = max(abs(s["loss"] - r["loss"]) / abs(r["loss"]) for s, r in zip(stats, ref["stats"]))
    total = float(np.sqrt(sum(norm(g) ** 2 for g in ref["grads"].values())))
    shares = {n: norm(grads[n] - g) / (STEP_GRAD_RTOL * norm(g) + STEP_GRAD_FLOOR * total)
              for n, g in ref["grads"].items()}
    worst = max(shares, key=shares.get)
    dp = [(params[n] - p).abs() for n, p in ref["params"].items()]
    return {"loss_rel_err": loss_rel, "grad_bar_share_worst": shares[worst],
            "grad_bar_worst_param": worst,
            "param_max_abs_err": max(float(d.max()) for d in dp),
            "params_above_1e-6": int(sum(int((d > 1e-6).sum()) for d in dp)),
            "param_bar": 2 * lr_steps}


def _check_step_errors(tag: str, err: dict) -> None:
    assert err["loss_rel_err"] <= STEP_LOSS_RTOL, (tag, err)
    assert err["grad_bar_share_worst"] <= 1.0, (tag, err)
    assert err["param_max_abs_err"] <= err["param_bar"], (tag, err)


def _par_train(rank: int, inputs: str, ref_path: str, out: str, device: str) -> dict:
    """8a/8b on one rank: DDP and ZeRO-1 from the same weights, batch and
    masks (two fp32 steps on this rank's row), held against the one-process
    run and ZeRO-1 against DDP; rank 0 writes each mode's npz."""
    d, ref = torch.load(inputs), torch.load(ref_path)
    lo, n = mesh.local_rows(PAR_BATCH)
    rows = {k: v[lo:lo + n] for k, v in d["batch"].items()}
    res, ddp_params = {}, None
    for mode in PAR_GLOO_MODES:
        print(f"phase parallel rank {rank}: {mode}", file=sys.stderr, flush=True)
        cfg = _par_cfg(mode)
        t0 = time.perf_counter()
        state, stats, grads, params, launches = _two_steps(cfg, d["sd"], rows, d["drops"], device)
        err = _step_errors(stats, grads, params, ref, sum(s["lr"] for s in stats))
        if ddp_params is None:
            ddp_params = params
        err["param_max_abs_err_vs_ddp"] = max(float((params[k] - p).abs().max())
                                              for k, p in ddp_params.items())
        # how much of the moments and params this rank holds
        total = sum(p.numel() for p in state.model.parameters())
        share = sum(collectives.local(p).numel() for g in state.optimizer.local.param_groups
                    for p in g["params"]) / total
        held = sum(collectives.local(p).numel() for p in state.model.parameters()) / total
        npz = cu.save_checkpoint(os.path.join(out, mode), state, 0, cfg)
        res[mode] = {"stats": stats, "errors": err, "launches_per_step": launches,
                     "moment_share": share, "param_share": held, "npz": npz,
                     "s": time.perf_counter() - t0}
        del state, grads, params
        torch.cuda.empty_cache()
    return res


def _par_timed(rank: int, device: str) -> dict:
    """8a's timing: the flagship in bf16 over fp32 masters at global batch
    8 (4 a rank), one warm-up and PAR_TIMED_STEPS steps (host clock around
    each synchronised step), then one step under torch.profiler: the
    device's busy ms and its copies (the gloo all-reduce stages each
    gradient bucket through the host: device to host, host to device)."""
    cfg = flagship_train_cfg()
    spec = build_spec(cfg)
    state = train_lib.create_train_state(cfg, spec, torch.Generator().manual_seed(SEED),
                                         device=device)
    step = train_lib.make_train_step(cfg, spec, STEPS_PER_EPOCH)
    lo, n = mesh.local_rows(PAR_TIMED_BATCH)
    batch = {k: v[lo:lo + n].to(device)
             for k, v in _par_batch(np.random.default_rng(SEED), PAR_TIMED_BATCH, spec).items()}
    gen = torch.Generator().manual_seed(SEED)
    step(state, batch, gen)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ms = []
    for _ in range(PAR_TIMED_STEPS):
        sync()
        t0 = time.perf_counter()
        stats, _ = step(state, batch, gen)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        assert np.isfinite(float(stats["loss"])), stats
    wall, busy, by_name, _ = device_trace(lambda: step(state, batch, gen))
    copies = sum(v for k, v in by_name.items() if "memcpy" in k.lower())
    return {"ms_per_step": ms, "median_ms": float(np.median(ms)), "traced_wall_ms": wall,
            "device_busy_ms": busy, "device_copies_ms": copies,
            "copies_share_of_busy": copies / busy if busy else 0.0}


def _par_eval(rank: int, cfgs: list, device: str) -> dict:
    """8c on one rank: ``tester.test`` on each config, with the rows of each
    forward it ran."""
    from csts_torch.eval import tester

    rows, make = [], train_lib.make_eval_step

    def counting(*a, **k):
        fn = make(*a, **k)

        def run(model, batch):
            rows.append(int(batch["video"].shape[0]))
            return fn(model, batch)
        return run

    train_lib.make_eval_step = counting
    out = []
    try:
        for cfg in cfgs:
            rows.clear()
            stats = tester.test(cfg, device)
            out.append({"stats": {k: stats[k] for k in EVAL_METRICS}, "rows": list(rows)})
    finally:
        train_lib.make_eval_step = make
    return out


EVAL_METRICS = ("f1", "recall", "precision", "threshold", "auc")


PAR_TASKS = {"train": _par_train, "timed": _par_timed, "eval": _par_eval}  # + phase 11's


def _par_rank(rank: int, init: str, world: int, tasks: list, out: str, device: str) -> None:
    """One spawned rank: joins the gloo group on the card, runs ``tasks``
    ([(name, args)]) in order, saves {name: result} for the parent. A fatal
    signal prints the rank's Python stack (``faulthandler``)."""
    import faulthandler

    faulthandler.enable()
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.distributed.init_process_group(
        "gloo", init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=300))
    try:
        res = {}
        for name, args in tasks:
            t0 = time.perf_counter()
            res[name] = PAR_TASKS[name](rank, *args, device)
            print(f"phase parallel rank {rank}: {name} done in {time.perf_counter() - t0:.2f} s",
                  file=sys.stderr, flush=True)
    finally:
        torch.distributed.destroy_process_group()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def spawn_ranks(tasks: list, out: str, device: str, timeout: float = 900.0,
                world: int = PAR_WORLD) -> list:
    """Runs ``tasks`` on ``world`` spawned ranks meeting through a store
    file (``mesh.rendezvous``); a rank that raises or a group past
    ``timeout`` seconds fails the phase (the ranks are killed)."""
    with mesh.rendezvous() as init:
        ctx = torch.multiprocessing.start_processes(
            _par_rank, args=(init, world, tasks, out, device), nprocs=world, join=False,
            start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1):
                assert time.monotonic() < deadline, f"the ranks ran past {timeout} s"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
            left = procs.wait_gone([p.pid for p in ctx.processes], AUDIT_GRACE_S)
            assert not left, f"ranks alive after the kill: {left}"
    return [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(world)]


def _par_eval_cfgs(root: str, rng: np.random.Generator) -> list:
    """8c's split (PAR_EVAL_CLIPS synthetic 256x320 clips) and seeded bf16
    weights; its configs at one and two views (TEST.BATCH_SIZE 6)."""
    from csts_torch.data.synthetic import write_dataset

    prefix, splits = write_dataset(root, "ego4d", num_clips=PAR_EVAL_CLIPS, frames=150,
                                   res=EVAL_RES, fps=30, seed=int(rng.integers(1 << 30)))
    cfg0 = flagship_cfg()
    model = CSTS(build_spec(cfg0))
    init_params(model, torch.Generator().manual_seed(SEED + 7))
    weights = os.path.join(root, "par_weights.pyth")
    torch.save({"model_state": model.state_dict()}, weights)
    cfgs = []
    for views in (1, 2):
        cfg = flagship_cfg()
        cfg.TRAIN.MIXED_PRECISION = True
        cfg.DATA.PATH_PREFIX, cfg.DATA.PATH_TO_DATA_DIR = prefix, splits
        cfg.DATA.DECODING_BACKEND = "npy"
        cfg.TRAIN.ENABLE = False
        cfg.TEST.DATASET = "ego4d_av_gaze_forecast" if views == 1 else "ego4d_av_gaze"
        cfg.TEST.BATCH_SIZE = PAR_EVAL_BATCH
        cfg.TEST.NUM_ENSEMBLE_VIEWS = views
        cfg.TEST.NUM_SPATIAL_CROPS = 1
        cfg.TEST.CHECKPOINT_FILE_PATH = weights
        cfg.TEST.SAVE_RESULTS_PATH = "results.npz"
        cfg.DATA_LOADER.NUM_WORKERS = 0
        cfg.OUTPUT_DIR = os.path.join(root, f"ranks_v{views}")
        cfg.LOG_PERIOD = 1000
        cfgs.append(cfg)
    return cfgs


def _nccl_world1(root: str, rng: np.random.Generator, device: str, inputs: dict,
                 ref: dict) -> dict:
    """run_net's own backend on the card: one ``init_from_cfg`` group under
    NCCL at world size 1. In it 8b's FSDP: two fp32 steps from ``inputs``
    (the whole batch of 2), held against ``ref`` by the caller, and its npz;
    then two trainer iterations (flagship, bf16, batch 8; the trainer wraps
    its model in DDP there), the training kernels' launches counted."""
    from csts_torch.data.synthetic import write_dataset
    from csts_torch.train import trainer

    prefix, splits = write_dataset(os.path.join(root, "nccl_split"), "ego4d", num_clips=4,
                                   frames=150, res=EVAL_RES, fps=30,
                                   seed=int(rng.integers(1 << 30)))
    train_csv = os.path.join(splits, "train_ego4d_gaze.csv")
    with open(train_csv) as f:
        clips = f.read().splitlines()
    with open(train_csv, "w") as f:
        f.write("\n".join(clips * 4) + "\n")  # 16 rows: 2 iterations of 8
    cfg = flagship_train_cfg()
    cfg.DATA.PATH_PREFIX, cfg.DATA.PATH_TO_DATA_DIR = prefix, splits
    cfg.DATA.DECODING_BACKEND = "npy"
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.TRAIN.EVAL_PERIOD = cfg.TRAIN.CHECKPOINT_PERIOD = 10  # neither runs
    cfg.TEST.ENABLE = False
    cfg.DATA_LOADER.NUM_WORKERS = 2
    cfg.OUTPUT_DIR = os.path.join(root, "nccl_run")
    cfg.LOG_PERIOD = 1
    got = mesh.init_from_cfg(cfg, device)
    try:
        backend = torch.distributed.get_backend()
        fsdp_cfg = _par_cfg("fsdp")
        t0 = time.perf_counter()
        state, stats, grads, params, launches = _two_steps(fsdp_cfg, inputs["sd"], inputs["batch"],
                                                           inputs["drops"], got)
        assert isinstance(next(state.model.parameters()), collectives.DTensor)
        fsdp = {"stats": stats, "launches_per_step": launches,
                "errors": _step_errors(stats, grads, params, ref, sum(s["lr"] for s in stats)),
                "npz": cu.save_checkpoint(os.path.join(root, "fsdp"), state, 0, fsdp_cfg)}
        fsdp["s"] = time.perf_counter() - t0
        del state, grads, params
        torch.cuda.empty_cache()
        reset_launches()
        t0 = time.perf_counter()
        state = trainer.train(cfg, got)
        res = {"backend": backend, "steps": state.step, "s": time.perf_counter() - t0, "fsdp": fsdp,
               "ddp": isinstance(state.net, torch.nn.parallel.DistributedDataParallel),
               "launches": {n: WRAPPERS[n].launches for n in PAR_TRAIN_KERNELS}}
        del state
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    return res


def _npz_headers(path: str) -> dict:
    """{leaf: (shape, dtype)} of an npz from its arrays' headers, no data read."""
    import zipfile

    out = {}
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            with z.open(info) as f:
                major, _ = np.lib.format.read_magic(f)
                read = (np.lib.format.read_array_header_1_0 if major == 1
                        else np.lib.format.read_array_header_2_0)
                shape, _, dtype = read(f)
            out[info.filename[:-len(".npy")]] = (shape, dtype)
    return out


def _npz_layouts_agree(paths: dict, p: int, bar: float) -> dict:
    """Each mode's npz against DDP's: the same leaves, shapes and dtypes
    (3P+4), the params within ``bar``."""
    out = {}
    want = _npz_headers(paths["ddp"])
    assert len(want) == 3 * p + 4, (len(want), p)
    keys = sorted(want)[:p]
    with np.load(paths["ddp"]) as ref:
        for mode, path in paths.items():
            assert _npz_headers(path) == want, mode
            with np.load(path) as blob:
                worst = max(float(np.abs(blob[k] - ref[k]).max()) for k in keys)
            assert worst <= bar, (mode, worst, bar)
            out[mode] = {"leaves": len(want), "param_max_abs_err_vs_ddp": worst,
                         "gb": os.path.getsize(path) / 1e9}
    return out


def parallel_phase(rng: np.random.Generator, device: str = "cuda") -> dict:
    """Phase 8: two ranks sharing the card over gloo (8a: DDP against one
    process, each rank's launches, then bf16 timing; 8b: ZeRO-1 against
    DDP; 8c: the tester on two ranks against one process at one and two
    views), then run_net's NCCL group at world size 1: 8b's FSDP against
    one process, the npz of each mode, and two trainer iterations."""
    import tempfile

    from csts_torch.eval import tester

    t_phase = time.perf_counter()
    cfg = _par_cfg()
    spec = build_spec(cfg)
    model = CSTS(spec)
    init_params(model, torch.Generator().manual_seed(SEED + 5))
    inputs = {"sd": {k: v.detach().clone() for k, v in model.state_dict().items()},
              "batch": _par_batch(rng, PAR_BATCH, spec),
              "drops": [sample_drop_masks(spec.video_blocks, PAR_BATCH,
                                          torch.Generator().manual_seed(SEED + s), "cpu")
                        for s in (11, 12)]}
    del model
    with tempfile.TemporaryDirectory() as root:
        inputs_path, ref_path = os.path.join(root, "inputs.pt"), os.path.join(root, "ref.pt")
        torch.save(inputs, inputs_path)
        t0 = time.perf_counter()
        state, stats, grads, params, launches = _two_steps(
            cfg, inputs["sd"], inputs["batch"], inputs["drops"], device)
        n_params = len(params)
        del state
        torch.cuda.empty_cache()
        ref = {"stats": stats, "grads": grads, "params": params}
        torch.save(ref, ref_path)
        ref_s = time.perf_counter() - t0
        eval_cfgs = _par_eval_cfgs(root, rng)

        t0 = time.perf_counter()
        ranks = spawn_ranks([("train", (inputs_path, ref_path, root)), ("timed", ()),
                             ("eval", (eval_cfgs,))], root, device)
        ranks_s = time.perf_counter() - t0
        res = {"reference": {"stats": stats, "launches_per_step": launches, "s": ref_s},
               "ranks_s": ranks_s}

        # 8a/8b: every gloo mode on each rank within the bars, launches per step
        for mode in PAR_GLOO_MODES:
            for r, rk in enumerate(ranks):
                got = rk["train"][mode]
                _check_step_errors(f"{mode} rank {r}", got["errors"])
                if device == "cuda":
                    for name in PAR_TRAIN_KERNELS:
                        assert got["launches_per_step"][name] == PER_STEP[name], (mode, r, got)
            log(f"phase parallel {mode}: two ranks sharing one card over gloo, fp32 batch "
                f"{PAR_BATCH} (1 a rank), 2 steps vs one process: loss rel err "
                + ", ".join(f"{rk['train'][mode]['errors']['loss_rel_err']:.3g}" for rk in ranks)
                + "; worst gradient bar share "
                + ", ".join(f"{rk['train'][mode]['errors']['grad_bar_share_worst']:.3g}"
                            for rk in ranks)
                + "; params max|Δ| "
                + ", ".join(f"{rk['train'][mode]['errors']['param_max_abs_err']:.3g}"
                            for rk in ranks)
                + f" (bar {ranks[0]['train'][mode]['errors']['param_bar']:.3g}), vs DDP "
                + ", ".join(f"{rk['train'][mode]['errors']['param_max_abs_err_vs_ddp']:.3g}"
                            for rk in ranks)
                + f"; launches a step per rank {[rk['train'][mode]['launches_per_step'] for rk in ranks]}"
                + f"; moments held {[round(rk['train'][mode]['moment_share'], 3) for rk in ranks]}"
                + f", params held {[round(rk['train'][mode]['param_share'], 3) for rk in ranks]}"
                + f"; {ranks[0]['train'][mode]['s']:.2f} s with the npz")
        for rk in ranks:
            z = rk["train"]["zero1"]
            assert 0.25 < z["moment_share"] < 0.75 and z["param_share"] == 1.0, z
        res["gloo"] = [rk["train"] for rk in ranks]
        timed = [rk["timed"] for rk in ranks]
        res["timed"] = timed
        log("phase parallel timing (two ranks sharing one card, not a scaling figure): bf16 "
            f"global batch {PAR_TIMED_BATCH} (4 a rank), median ms/step "
            + ", ".join(f"{t['median_ms']:.2f}" for t in timed)
            + f" (rank 0, 1); one traced step: device busy "
            + ", ".join(f"{t['device_busy_ms']:.2f}" for t in timed)
            + " ms, of which device copies (gloo's all-reduce staged through the host) "
            + ", ".join(f"{t['device_copies_ms']:.2f} ({t['copies_share_of_busy']:.3f})"
                        for t in timed) + f" ({CARD})")

        # 8c: the tester on two ranks against one process. The kernels' bf16
        # outputs depend on the batch's size (tile and key-split choices) and
        # the AUC ranks bf16 ties, so one process runs the ranks' forward
        # batch (3): its batches are then the ranks' stripes, row for row.
        for views, cfg_v, got in zip((1, 2), eval_cfgs, zip(*(rk["eval"] for rk in ranks))):
            one = copy.deepcopy(cfg_v)
            one.OUTPUT_DIR = os.path.join(root, f"one_v{views}")
            one.TEST.BATCH_SIZE = PAR_EVAL_BATCH // PAR_WORLD
            want = tester.test(one, device)
            for r, g in enumerate(got):
                assert g["stats"]["threshold"] == want["threshold"], (views, r)
                for k in EVAL_METRICS:
                    assert abs(g["stats"][k] - want[k]) <= EVAL_TOL, (views, r, k, g, want)
            a = np.load(os.path.join(cfg_v.OUTPUT_DIR, "results.npz"))
            b = np.load(os.path.join(one.OUTPUT_DIR, "results.npz"))
            np.testing.assert_array_equal(a["index"], np.arange(PAR_EVAL_CLIPS * views))
            for k in b.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            rows = [g["rows"] for g in got]
            assert sum(sum(r) for r in rows) == PAR_EVAL_CLIPS * views, rows
            res[f"eval_views{views}"] = {"ranks": got, "one_process": {
                k: want[k] for k in EVAL_METRICS}}
            log(f"phase parallel eval: {views} view(s), {PAR_EVAL_CLIPS * views} rows on two ranks "
                f"(rows a forward {rows}): f1 {got[0]['stats']['f1']:.6f} vs one process "
                f"{want['f1']:.6f}, max |Δ| over f1/recall/precision/auc "
                f"{max(abs(g['stats'][k] - want[k]) for g in got for k in EVAL_METRICS):.3g}; "
                "every row scored once")
        assert res["eval_views1"]["ranks"][1]["rows"] == [3, 3, 3], res["eval_views1"]

        # 8b's FSDP and 8c's trainer under run_net's NCCL group at world size 1
        nccl = _nccl_world1(root, rng, device, inputs, ref)
        fsdp = res["fsdp_nccl_world1"] = nccl.pop("fsdp")
        _check_step_errors("fsdp", fsdp["errors"])
        if device == "cuda":
            for name in PAR_TRAIN_KERNELS:
                assert fsdp["launches_per_step"][name] == PER_STEP[name], fsdp
        log(f"phase parallel fsdp: NCCL at world size 1 (FSDP2 over a one-card mesh), fp32 "
            f"batch {PAR_BATCH}, 2 steps vs one process: loss rel err "
            f"{fsdp['errors']['loss_rel_err']:.3g}; worst gradient bar share "
            f"{fsdp['errors']['grad_bar_share_worst']:.3g}; params max|Δ| "
            f"{fsdp['errors']['param_max_abs_err']:.3g} (bar {fsdp['errors']['param_bar']:.3g}); "
            f"launches a step {fsdp['launches_per_step']}; {fsdp['s']:.2f} s with the npz")

        npz = {m: ranks[0]["train"][m]["npz"] for m in PAR_GLOO_MODES}
        npz["fsdp"] = fsdp["npz"]
        res["npz"] = _npz_layouts_agree(npz, n_params, ranks[0]["train"]["ddp"]["errors"]["param_bar"])
        log("phase parallel npz: " + ", ".join(
            f"{m} {v['leaves']} leaves {v['gb']:.3f} GB, params max|Δ| vs DDP "
            f"{v['param_max_abs_err_vs_ddp']:.3g}" for m, v in res["npz"].items()))

        assert nccl["ddp"] and nccl["steps"] == 2, nccl
        if device == "cuda":
            for name in PAR_TRAIN_KERNELS:
                assert nccl["launches"][name] == 2 * PER_STEP[name], nccl
        res["nccl_world1"] = nccl
        log(f"phase parallel nccl: init_from_cfg's group ({nccl['backend']}, world 1): the "
            f"trainer {nccl['steps']} iterations through DDP in {nccl['s']:.2f} s, launches "
            f"{nccl['launches']}")
    res["s"] = time.perf_counter() - t_phase
    log(f"phase parallel: {res['s']:.2f} s")
    return res



# --- phase 9: the forward's whole surface ----------------------------------------
#
# At flagship width (bf16, 256², seeded weights): the fusion blocks' attention
# maps and the captured activations, MVIT.SPATIAL_AUDIO_ATTN (a forward and a
# training step), the head_commute and t2_skip switches under one predictor,
# run_net's training with AUG.ENABLE, and tools/visualize.py.

SURFACE_BATCH = 8
MAP_BAR = 0.02   # a probability's max|Δ| against the fp32 plain twins (the softmax bar)
AUG_WORKERS = 4  # DATA_LOADER.NUM_WORKERS of the AUG runs
VIS_CLIPS = 4


def _walk_blocks(model, add, maps: bool = False) -> None:
    """``add(block spec, mask, thw, attn)`` for every block of ``model`` in
    the forward's order on its input grid (the fusion blocks with ``attn``
    when ``maps``, and the spatial fusion also under MVIT.SPATIAL_AUDIO_ATTN)."""
    from csts_torch.models.csts import _thw_after_blocks

    spec = model.spec

    def walk(b, mask, thw, attn=False):
        add(b, mask, thw, attn)
        if b.upsample_q:
            return tmvit._static_upsample_out(thw, b.kernel_q, b.stride_q, b.padding_q,
                                              b.output_padding_q)
        return _thw_after_blocks(thw, [b])

    for blocks, thw in ((spec.video_blocks, spec.patch_dims),
                        (spec.audio_blocks, spec.audio_patch_dims)):
        for b in blocks:
            thw = walk(b, None, thw)
    walk(spec.spatial_fusion, model.inframe_mask, spec.fusion_thw,
         maps or spec.spatial_audio_attn)
    walk(spec.temporal_fusion, None, (2, 2, 2), maps)
    thw = spec.fusion_thw
    for b in spec.decoder_blocks:
        thw = walk(b, None, thw)


def _skip_launches(plan: dict, b, route: str) -> None:
    """K3 at a stride-(2,1,1) skip while ``kup.T2_SKIP_KERNEL`` is set, B9a at
    a (1,2,2) skip of B5's route while ``kup.HW2_SKIP_KERNEL`` is (at eval and
    in B5's training forward)."""
    if not (b.upsample_q and b.skip_upsample_on) or route == "plain":
        return
    stride = tuple(b.stride_q)
    plan["t2_upsample"] += stride == (2, 1, 1) and kup.T2_SKIP_KERNEL
    plan["hw2_upsample"] += (stride == (1, 2, 2) and route == "decoder_block"
                             and kup.HW2_SKIP_KERNEL)


def route_plan(model, maps: bool = False) -> dict:
    """Each kernel's launches in one eval forward of ``model`` as
    ``mvit.block_route`` routes its blocks (the fusion blocks on the
    "attn_map" route when ``maps``, and the spatial fusion also under
    MVIT.SPATIAL_AUDIO_ATTN), with K3 at the x2 T resizes while
    ``kup.T2_SKIP_KERNEL`` is set and B9a at the (1,2,2) skips of B5's route
    while ``kup.HW2_SKIP_KERNEL`` is."""
    plan = {name: 0 for name in PER_FORWARD}

    def add(b, mask, thw, attn):
        route = tmvit.block_route(b, mask, thw, attn)
        if route in ("block", "pool_block", "decoder_block"):
            plan[route] += 1
        else:
            plan["mlp_tail"] += 1
            plan["attention"] += route == "composite"
        _skip_launches(plan, b, route)

    _walk_blocks(model, add, maps)
    plan["t2_upsample"] += bool(kup.T2_SKIP_KERNEL)  # the head's stem map
    return plan


def train_plan(model) -> dict:
    """Each kernel's launches in one training step of ``model`` (forward and
    backward) as ``mvit.train_route`` routes its blocks under the JAX
    package's switches: B5 at a "decoder_block" block; on the "composite"
    route B7, and K1 forward with, where there is no mask, B8 backward while
    TRAIN_ATTN is on; the "attn_map" route (the spatial fusion under
    MVIT.SPATIAL_AUDIO_ATTN) B7 only; nothing with the kernels off. K3 at the
    stride-(2,1,1) skip and the head's stem map while ``kup.T2_SKIP_KERNEL``
    is set, B9a inside B5's forward while ``kup.HW2_SKIP_KERNEL`` is."""
    plan = {name: 0 for name in PER_STEP}

    def add(b, mask, thw, attn):
        route = tmvit.train_route(b, mask, thw, attn)
        if route == "decoder_block":
            plan["decoder_block"] += 1
        elif route != "plain":
            plan["mlp_tail_train"] += 1
            k1 = route == "composite" and ka.train_attention_enabled()
            plan["attention"] += k1
            plan["attention_bwd"] += k1 and mask is None
        _skip_launches(plan, b, route)

    _walk_blocks(model, add)
    plan["t2_upsample"] += bool(kup.T2_SKIP_KERNEL) and ka.enabled()  # the head's stem map
    return plan


def _forward_launches(fn):
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {name: WRAPPERS[name].launches for name in PER_FORWARD}


def maps_check(state: dict, spec, v, a) -> dict:
    """9a: the forward with both maps and ``extract_activations`` through
    the kernels, launches against ``route_plan``; the logits against the
    forward without maps, the maps against the fp32 plain twins."""
    from csts_torch.models.csts import CAPTURABLE, extract_activations
    from csts_torch.tools import check_line, heatmap_check

    model = CSTS(spec)
    model.load_state_dict(state)
    model = model.to(torch.bfloat16).cuda().eval()
    with torch.inference_mode():
        plain, n_plain = _forward_launches(lambda: model(v, a))
        (logits, smap, tmap), n_maps = _forward_launches(
            lambda: model(v, a, return_spatial_attn=True, return_temporal_attn=True))
        (_, acts), n_acts = _forward_launches(lambda: extract_activations(model, v, a))
    plan, plan_maps = route_plan(model), route_plan(model, maps=True)
    log(f"phase surface maps: launches without maps {n_plain}, with both maps {n_maps}, "
        f"extract_activations {n_acts}; block_route's plans {plan} and {plan_maps}")
    assert plan == PER_FORWARD, (plan, PER_FORWARD)
    assert n_plain == plan and n_acts == plan, (n_plain, n_acts, plan)
    assert n_maps == plan_maps, (n_maps, plan_maps)
    assert plan_maps == {**plan, "attention": plan["attention"] - 2}, plan_maps
    chk = heatmap_check(logits, plain)
    t, h, w = spec.fusion_thw
    n = spec.spatial_fusion.num_heads
    assert smap.shape == (SURFACE_BATCH, n, t * h * w + t, t * h * w + t), smap.shape
    assert tmap.shape == (SURFACE_BATCH, spec.temporal_fusion.num_heads, 2 * t, 2 * t)
    assert smap.dtype == tmap.dtype == torch.float32
    del logits, plain
    ref = CSTS(dataclasses.replace(spec, dtype="float32"))
    ref.load_state_dict(state)
    ref = ref.cuda().eval()
    with plain_twins(), torch.inference_mode():
        _, ref_s, ref_t = ref(v, a, return_spatial_attn=True, return_temporal_attn=True)
    ds, dt = float((smap - ref_s).abs().max()), float((tmap - ref_t).abs().max())
    rows = float((smap.sum(-1) - 1).abs().max())
    names = sorted(acts)
    finite = all(bool(torch.isfinite(x).all()) for x in acts.values())
    log(f"phase surface maps: logits with maps against without: {check_line(chk)}; spatial map "
        f"{tuple(smap.shape)} max|Δ| {ds:.3g}, temporal map {tuple(tmap.shape)} max|Δ| {dt:.3g} "
        f"against the fp32 plain twins (bar {MAP_BAR}), rows sum to 1 within {rows:.2g}; "
        f"{len(names)} activations ({', '.join(CAPTURABLE)}) all finite: {finite}")
    assert chk["ok"], chk
    assert ds < MAP_BAR and dt < MAP_BAR and rows < 1e-4, (ds, dt, rows)
    assert len(names) == 2 + len(spec.video_blocks) + len(spec.audio_blocks) + 2 + 4 and finite
    del ref, ref_s, ref_t, smap, tmap, acts, model
    torch.cuda.empty_cache()
    return {"launches": n_plain, "launches_maps": n_maps, "plan_maps": plan_maps,
            "logits": chk, "spatial_map_max_abs_diff": ds, "temporal_map_max_abs_diff": dt,
            "activations": names}


def audio_attn_check(state: dict, spec, v, a, rng) -> dict:
    """9b: MVIT.SPATIAL_AUDIO_ATTN: the forward through the kernels against
    its fp32 plain twins at the golden bar (launches against ``route_plan``),
    then one training step from ``flagship_train_cfg``, loss and gradient
    norm finite (K1 leaves the spatial fusion: PER_STEP less one)."""
    from csts_torch.tools import check_line, heatmap_check

    aa_spec = dataclasses.replace(spec, spatial_audio_attn=True)
    model = CSTS(aa_spec)
    model.load_state_dict(state)
    model = model.to(torch.bfloat16).cuda().eval()
    with torch.inference_mode():
        logits, launches = _forward_launches(lambda: model(v, a))
    plan = route_plan(model)
    del model
    ref = CSTS(dataclasses.replace(aa_spec, dtype="float32"))
    ref.load_state_dict(state)
    ref = ref.cuda().eval()
    with plain_twins(), torch.inference_mode():
        chk = heatmap_check(logits, ref(v, a))
    del ref, logits
    torch.cuda.empty_cache()

    cfg = flagship_train_cfg()
    cfg.MVIT.SPATIAL_AUDIO_ATTN = True
    tspec = build_spec(cfg)
    st = train_lib.create_train_state(cfg, tspec, torch.Generator().manual_seed(SEED),
                                      device="cuda")
    step = train_lib.make_train_step(cfg, tspec, steps_per_epoch=STEPS_PER_EPOCH)
    batch = make_train_batch(rng, cfg.TRAIN.BATCH_SIZE, tspec)
    reset_launches()
    stats, _ = step(st, batch, torch.Generator().manual_seed(SEED + 1))
    stats = {k: float(x) for k, x in stats.items()}
    step_launches = {name: WRAPPERS[name].launches for name in PER_STEP}
    log(f"phase surface SPATIAL_AUDIO_ATTN: forward launches {launches} (plan {plan}); "
        f"against the fp32 plain twins: {check_line(chk)}; one training step: loss "
        f"{stats['loss']:.6g}, grad_norm {stats['grad_norm']:.6g}, launches {step_launches}")
    assert launches == plan and plan["attention"] == PER_FORWARD["attention"] - 1, (launches, plan)
    assert chk["ok"], chk
    assert all(np.isfinite(x) for x in stats.values()), stats
    want = {**PER_STEP, "attention": PER_STEP["attention"] - 1}
    assert step_launches == want, (step_launches, want)
    del st, step, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "reference": chk, "train_step": stats,
            "train_launches": step_launches}


def switch_check(state: dict, cfg, spec, rng) -> dict:
    """9c: head_commute and t2_skip, each flipped from the defaults under one
    predictor (bucket 8): the first request after a flip drops the stale
    graph and runs eagerly, the second captures a new one, the third
    replays; K3's launches on each (2, 2, 0 with t2_skip on; 0, 0, 0 off);
    the per-frame softmax within the golden bar of the defaults'."""
    pred = GazePredictor(cfg, state, batch_sizes=(8,))
    video, audio = make_inputs(rng, 8, spec)
    with switches("base"):
        for _ in range(2):  # eager, then the capture
            want = pred.predict(video, audio)["heatmaps"]
    slot = pred._slots[8]
    res = {}
    for flipped, conf in (("t2_skip", "head_commute"), ("head_commute", "t2_skip")):
        old, k3, graphs = slot.graph, [], []
        assert old is not None
        with ab_flags.flags(conf):
            for _ in range(3):
                reset_launches()
                got = pred.predict(video, audio)["heatmaps"]
                k3.append(WRAPPERS["t2_upsample"].launches)
                graphs.append(slot.graph)
        chk = _golden(got, want)
        res[flipped] = {"k3_launches": k3, "softmax": chk}
        log(f"phase surface switch {flipped} off: K3 launches on the three requests after the "
            f"flip {k3} (defaults: 2 a forward); graph dropped on the first, a new one captured "
            f"on the second: {graphs[0] is None and graphs[1] is not None and graphs[1] is not old}"
            f"; per-frame softmax against the defaults max|Δ| {chk['softmax_max_abs_diff']:.3g}")
        assert graphs[0] is None and graphs[1] is not None and graphs[1] is not old
        assert graphs[2] is graphs[1]
        assert k3 == ([0, 0, 0] if flipped == "t2_skip" else [2, 2, 0]), k3
        assert chk["ok"], chk
    del pred
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def _train_waits(seen: dict):
    """Records the consumer's waits on the prefetcher inside training epochs
    and each epoch's seconds (run_net's trainer, patched back on exit)."""
    from csts_torch.train import trainer as trainer_lib

    next_batch, train_epoch = loader_lib.DevicePrefetcher.__next__, trainer_lib._train_epoch

    def timed_next(self):
        t = time.perf_counter()
        try:
            return next_batch(self)
        finally:
            if seen["in_train"]:
                seen["waits"].append(time.perf_counter() - t)

    def timed_epoch(*a, **k):
        seen["in_train"] = True
        t = time.perf_counter()
        try:
            return train_epoch(*a, **k)
        finally:
            seen["in_train"] = False
            seen["epochs"].append(time.perf_counter() - t)

    try:
        loader_lib.DevicePrefetcher.__next__ = timed_next
        trainer_lib._train_epoch = timed_epoch
        yield
    finally:
        loader_lib.DevicePrefetcher.__next__ = next_batch
        trainer_lib._train_epoch = train_epoch


def aug_check(root: str, rng, audit: "ProcessAudit") -> dict:
    """9d: run_net's training at flagship width on phase 7's kind of split,
    one epoch of 6 iterations with AUG.ENABLE (the config's AUG.* values:
    RandAugment rand-m7-n4-mstd0.5-inc1, random erasing at RE_PROB 0.25) and
    AUG_WORKERS loader workers, and the same without AUG: launches (PER_STEP
    a step), the loader's wait share after the first batch; after each, no
    loader worker alive. Returns the AUG run's results and output directory."""
    from multiprocessing import forkserver

    from csts_torch.tools import run_net

    split = _trainer_split(os.path.join(root, "data"), int(rng.integers(1 << 30)))
    pyths, _ = _trainer_pyths(root)
    res = {}
    iters = TRAINER_TRAIN_ROWS // 8
    for aug in (False, True):
        out = os.path.join(root, f"aug_{aug}")
        args = _run_net_args(split, pyths, out, AUG_WORKERS, False) + [
            "SOLVER.MAX_EPOCH", "1", "TRAIN.CHECKPOINT_PERIOD", "1", "TRAIN.EVAL_PERIOD", "2",
            "AUG.ENABLE", str(aug)]
        seen = {"waits": [], "epochs": [], "in_train": False}
        audit.at(f"surface trainer AUG.ENABLE {aug}")
        reset_launches()
        t = time.perf_counter()
        with _train_waits(seen):
            run_net.main(args)
        run_s = time.perf_counter() - t
        launches = {name: WRAPPERS[name].launches for name in PER_STEP}
        waits = seen["waits"]
        loop_s = seen["epochs"][0] - waits[0]
        share = sum(waits[1:]) / loop_s
        fs = forkserver._forkserver._forkserver_pid
        workers = procs.descendants(fs) if fs else {}
        res["aug" if aug else "plain"] = {
            "run_s": run_s, "epoch_s": seen["epochs"][0], "first_wait_s": waits[0],
            "loader_wait_share": share, "launches": launches, "workers_alive": len(workers)}
        log(f"phase surface trainer AUG.ENABLE {aug}: run_net 1 epoch of {iters} iterations at "
            f"batch 8, {AUG_WORKERS} workers, {run_s:.1f} s (epoch {seen['epochs'][0]:.2f} s, "
            f"first batch waited {waits[0]:.2f} s); loader wait share {share:.3f} after the "
            f"first batch; launches {launches}; loader workers alive after it: {len(workers)} "
            f"({CARD})")
        assert not workers, workers
        for name, per in PER_STEP.items():
            assert launches[name] == per * iters, (name, launches[name], per * iters)
    audit.at("surface visualize")
    return res, os.path.join(root, "aug_True"), split


def vis_check(split, out: str, root: str) -> dict:
    """9e: ``tools/visualize.py`` with ``--attention`` on VIS_CLIPS clips of
    the test split from the AUG run's npz: the files written (per clip T
    overlays, heads x T spatial maps, heads temporal matrices), each read
    back by the port's PNG reader at its size; the forward's launches
    against ``route_plan`` with maps."""
    from csts_torch.eval.visualization import read_png
    from csts_torch.tools import visualize

    prefix, splits = split
    npz = cu.get_last_checkpoint(out)
    vis_dir = os.path.join(root, "vis")
    reset_launches()
    t = time.perf_counter()
    visualize.main(["--cfg", YAML, "--num-clips", str(VIS_CLIPS), "--attention",
                    "--out", vis_dir, "NUM_DEVICES", "1", "DATA.PATH_PREFIX", prefix,
                    "DATA.PATH_TO_DATA_DIR", splits, "DATA.DECODING_BACKEND", "npy",
                    "TRAIN.MIXED_PRECISION", "True", "TEST.CHECKPOINT_FILE_PATH", npz,
                    "TEST.BATCH_SIZE", "8", "DATA_LOADER.NUM_WORKERS", "2", "OUTPUT_DIR", out])
    vis_s = time.perf_counter() - t
    launches = {name: WRAPPERS[name].launches for name in PER_FORWARD}
    spec = build_spec(flagship_cfg())
    s = spec.crop_size
    t_out, (t_f, _, _) = spec.num_frames, spec.fusion_thw
    heads_s, heads_t = spec.spatial_fusion.num_heads, spec.temporal_fusion.num_heads
    counts, sizes = {}, {}
    for d, _, names in os.walk(vis_dir):
        kind = os.path.basename(d)
        kind = kind if kind in ("spatial_attn", "temporal_attn") else "overlay"
        for n in names:
            counts[kind] = counts.get(kind, 0) + 1
            sizes.setdefault(kind, set()).add(read_png(os.path.join(d, n)).shape)
    want = {"overlay": VIS_CLIPS * t_out, "spatial_attn": VIS_CLIPS * heads_s * t_f,
            "temporal_attn": VIS_CLIPS * heads_t}
    log(f"phase surface visualize: {sum(counts.values())} PNGs in {vis_s:.1f} s ({counts}; sizes "
        f"{ {k: sorted(v) for k, v in sizes.items()} }), each read back; launches {launches}")
    assert counts == want, (counts, want)
    assert sizes == {"overlay": {(s, 2 * s, 3)}, "spatial_attn": {(s, s, 3)},
                     "temporal_attn": {(256, 256, 3)}}, sizes
    plan = {**PER_FORWARD, "attention": PER_FORWARD["attention"] - 2}
    assert launches == plan, (launches, plan)
    return {"files": counts, "s": vis_s, "launches": launches}


def surface_phase(rng: np.random.Generator, audit: "ProcessAudit") -> dict:
    """Phase 9: the forward's whole surface at flagship width."""
    t_phase = time.perf_counter()
    cfg = flagship_cfg()
    cfg.TRAIN.MIXED_PRECISION = True
    spec = build_spec(cfg)
    ref = CSTS(dataclasses.replace(spec, dtype="float32"))
    init_params(ref, torch.Generator().manual_seed(SEED))
    state = ref.state_dict()
    del ref
    video, audio = make_inputs(rng, SURFACE_BATCH, spec)
    v, a = torch.from_numpy(video).cuda(), torch.from_numpy(audio).cuda()
    res = {"maps": maps_check(state, spec, v, a),
           "spatial_audio_attn": audio_attn_check(state, spec, v, a, rng)}
    del v, a
    res["switches"] = switch_check(state, cfg, spec, rng)
    with tempfile.TemporaryDirectory() as root:
        res["aug"], out, split = aug_check(root, rng, audit)
        res["visualize"] = vis_check(split, out, root)
    res["s"] = time.perf_counter() - t_phase
    log(f"phase surface: {res['s']:.2f} s")
    return res


# phase 10: the MViT-B 16x4 classifier (presets.mvit_b_16x4_cfg, 16 frames at
# 224², 16 blocks) built by build_model, bf16, at these batches
CLASSIFIER_BATCHES = (1, 8)
# launches a forward from block_route at 16x224²: with the cls token every
# block takes K1+K2 (B3 and B4 refuse a cls token); without it B3 takes v0
# and v2 (Lk 392) and K1+K2 the other 14 (B4 refuses Lk 1568 > 1024 at v1,
# v3 and v14)
CLASSIFIER_PLAN = {True: {"attention": 16, "mlp_tail": 16, "block": 0},
                   False: {"attention": 14, "mlp_tail": 14, "block": 2}}
CLASSIFIER_FORWARD_S = 0.5  # CUDA-event timing of the batch-8 forward
#: the bf16 logits against the fp32 plain twins: max|Δ| within this share of
#: max(1, the largest |logit|), the class softmax (400 classes) within
#: CLASSIFIER_SOFTMAX_BAR, set from the readings (at most 7.6e-5 at batches 1 and 8)
CLASSIFIER_LOGIT_BAR = 0.05
CLASSIFIER_SOFTMAX_BAR = 1e-3
NATIVE_CLIPS = 32       # the loader benchmark's distinct synthetic clips (256x320) ...
NATIVE_REPEATS = 36     # ... each listed this often in the train split
NATIVE_WORKERS = 4
NATIVE_BATCHES = 128    # timed batches of 8 after one warm-up batch (~4 s)


def classifier_plan(model) -> dict:
    """Each kernel's launches in one eval forward of the classifier ``model``
    as ``mvit.block_route`` routes its blocks."""
    plan = {name: 0 for name in PER_FORWARD}
    thw = model.spec.patch_dims
    for b in model.spec.blocks:
        route = tmvit.block_route(b, None, thw)
        if route in WHOLE_BLOCKS:
            plan[route] += 1
        else:
            plan["attention"] += 1
            plan["mlp_tail"] += 1
        if b.pool_q_on:
            thw = tmvit._static_pool_out(thw, b.kernel_q, b.stride_q, b.padding_q)
    return plan


def classifier_logits_check(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """bf16 logits against the fp32 plain twins' on the same inputs: max|Δ|,
    the class softmax's max|Δ| and the top class where the top-2 gap
    exceeds twice the error."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    dsm = float((got.softmax(-1) - ref.softmax(-1)).abs().max())
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * err
    agree = int((got.argmax(-1) == ref.argmax(-1))[decided].sum())
    ok = (err <= CLASSIFIER_LOGIT_BAR * scale and dsm < CLASSIFIER_SOFTMAX_BAR
          and agree == int(decided.sum()) and bool(torch.isfinite(got).all()))
    return {"ok": ok, "max_abs_diff": err, "bar": CLASSIFIER_LOGIT_BAR * scale,
            "softmax_max_abs_diff": dsm, "decided": int(decided.sum()), "top1_agree": agree}


def classifier_run(cls: bool, rng: np.random.Generator) -> dict:
    """10a/10b: the classifier with the cls token on or off."""
    from csts_torch.models.build import build_model
    from csts_torch.models.mvit_classifier import MViT, build_mvit_spec
    from csts_torch.presets import mvit_b_16x4_cfg

    tag = "cls" if cls else "no_cls"
    cfg = mvit_b_16x4_cfg()
    cfg.MVIT.CLS_EMBED_ON = cls
    cfg.TRAIN.MIXED_PRECISION = True
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda").to(torch.bfloat16).eval()
    build_s = time.perf_counter() - t0
    cfg32 = copy.deepcopy(cfg)
    cfg32.TRAIN.MIXED_PRECISION = False
    ref = MViT(build_mvit_spec(cfg32))
    ref.load_state_dict(model.state_dict())  # the same (bf16-rounded) weights in fp32
    ref = ref.cuda().eval()
    plan = classifier_plan(model)
    want = {name: 0 for name in PER_FORWARD}
    want.update(CLASSIFIER_PLAN[cls])
    log(f"phase classifier {tag}: build_model {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M "
        f"params in {build_s:.2f} s; block_route's plan {plan}")
    assert plan == want, (plan, want)
    spec = model.spec
    res = {"plan": plan, "build_s": build_s, "batches": {}}
    calls_by_bucket = {}
    for batch in CLASSIFIER_BATCHES:
        video = torch.from_numpy(rng.standard_normal(
            (batch, spec.num_frames, spec.crop_size, spec.crop_size, 3), dtype=np.float32)).cuda()
        calls = {name: {} for name in KERNELS}
        with torch.inference_mode():
            with recording(calls):
                model(video)
            torch.cuda.synchronize()
            logits, launches = _forward_launches(lambda: model(video))
            with plain_twins():
                ref_logits = ref(video)
        recorded = {n: sum(c for c, _, _ in sigs.values()) for n, sigs in calls.items()}
        chk = classifier_logits_check(logits, ref_logits)
        log(f"phase classifier {tag} batch {batch}: launches {launches} (recorded "
            f"{recorded}); logits {tuple(logits.shape)} max|Δ| {chk['max_abs_diff']:.4g} "
            f"(bar {chk['bar']:.4g}) against the fp32 plain twins, class softmax max|Δ| "
            f"{chk['softmax_max_abs_diff']:.3g}, top-1 agrees on {chk['top1_agree']}/"
            f"{chk['decided']} decided clips")
        assert launches == plan and recorded == {n: plan[n] for n in calls}, (launches, recorded)
        assert chk["ok"], chk
        assert tuple(logits.shape) == (batch, spec.num_classes)
        calls_by_bucket[batch] = calls
        res["batches"][batch] = {"launches": launches, "logits": chk}
        del logits, ref_logits
        if batch != max(CLASSIFIER_BATCHES):
            del video
    del ref
    torch.cuda.empty_cache()
    with torch.inference_mode():
        res["kernels"] = check_kernels(calls_by_bucket, timing="device")
    # a batch-8 forward's share of each kernel: device ms, the library
    # call's and the bound, summed over its shapes times their launches, and
    # its device activities (from the launches, each shape's per call)
    per, expect = {}, {}
    for name, rep in res["kernels"].items():
        rows = [r for r in rep["shapes"] if "device_ms" in r]
        if rows:
            per[name] = {"launches": sum(r["launches_per_forward"] for r in rows),
                         "device_ms": _total(rows, "device_ms", "launches_per_forward"),
                         "bound_ms": _total(rows, "bound_ms", "launches_per_forward"),
                         "library_device_ms": (
                             _total(rows, "library_device_ms", "launches_per_forward")
                             if KERNELS[name]["library"] else None)}
            for r in rows:
                for act, n in (r["activities"] or {}).items():
                    if family(act) in PORT_FAMILIES:
                        expect[act] = expect.get(act, 0) + n * r["launches_per_forward"]
    res["per_forward"] = per
    log(f"phase classifier {tag}: a batch-8 forward's kernels, device ms (library device ms, "
        "bound ms): " + "; ".join(
            f"{n} x{p['launches']} {_ms(p['device_ms'])} ({_ms(p['library_device_ms'])}, "
            f"{p['bound_ms']:.4f})" for n, p in per.items()) + f" ({CARD})")
    # the batch-8 forward by events, then its device time in a window that
    # holds every activity of the port's kernels that its launches make
    batch = max(CLASSIFIER_BATCHES)
    row = res["batches"][batch]
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(video), target_s=CLASSIFIER_FORWARD_S)
        measured = all(r["activities"] is not None for rep in res["kernels"].values()
                       for r in rep["shapes"] if "device_ms" in r)
        prof = profile_forward(lambda: model(video), fwd_ms, log=log,
                               expect=expect if measured else None)
    whole = bool(prof["whole"])
    row.update(ms=fwd_ms, clips_per_s=batch * 1e3 / fwd_ms, profile=prof,
               device_busy_ms=prof["device_busy_ms"] if whole else None)
    log(f"phase classifier {tag} batch {batch}: forward {fwd_ms:.3f} ms (events) = "
        f"{row['clips_per_s']:.2f} clips/s, device busy "
        + (f"{prof['device_busy_ms']:.3f} ms over {prof['device_kernels']} activities "
           f"(window {prof['traces']})" if whole else
           f"not measured (no window of {prof['traces']} was whole)")
        + (f", the port's {sum(expect.values())} as launched" if measured else
           ", the port's activities not checked (a shape's not measured)") + f" ({CARD})")
    del model, video
    torch.cuda.empty_cache()
    return res


def native_check(rng: np.random.Generator) -> dict:
    """10c: the native loader ops (g++ at first use) bit-equal to their numpy
    twins at the flagship loader's shapes, and ``benchmark_data_loading``
    on a synthetic train split with NATIVE_WORKERS workers."""
    from csts_torch import native
    from csts_torch.data.synthetic import write_dataset
    from csts_torch.native import build as nbuild
    from csts_torch.native import twins
    from csts_torch.utils.misc import benchmark_data_loading

    t0 = time.perf_counter()
    so = nbuild.build()
    build_s = time.perf_counter() - t0
    frames = rng.integers(0, 256, (8, 256, 320, 3), dtype=np.uint8)
    gaze = rng.uniform(-0.1, 1.1, (8, 3)).astype(np.float32)
    audio = rng.standard_normal((256, 2000)).astype(np.float32)
    centers = np.sort(rng.integers(128, 2000 - 128, 8))
    mean, std = [0.45] * 3, [0.225] * 3
    cases = {
        "crop_flip_normalize_uint8": lambda m: m.fused_crop_flip_normalize(
            frames, 0, 32, 256, True, mean, std),
        "crop_flip_normalize_f32": lambda m: m.fused_crop_flip_normalize(
            frames.astype(np.float32) / 255.0, 0, 10, 256, False, mean, std),
        "gaze_heatmaps": lambda m: m.gaze_heatmaps(gaze, 8, 64, 64, 19),
        "audio_slice_gather": lambda m: m.audio_slice_gather(audio, centers, 128),
    }
    res = {"build_s": build_s, "library": os.path.relpath(so, ROOT), "ops": {}}
    for name, run in cases.items():
        got, want = run(native), run(twins)
        equal = bool(np.array_equal(got, want))
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            run(native)
        native_ms = (time.perf_counter() - t0) / reps * 1e3
        t0 = time.perf_counter()
        for _ in range(reps):
            run(twins)
        twin_ms = (time.perf_counter() - t0) / reps * 1e3
        res["ops"][name] = {"bit_equal": equal, "native_ms": native_ms, "twin_ms": twin_ms}
        assert equal, name
    log(f"phase classifier native: loader ops built in {build_s:.2f} s ({res['library']}); "
        + "; ".join(f"{n} bit-equal {r['bit_equal']}, native {r['native_ms']:.3f} ms vs numpy "
                    f"twin {r['twin_ms']:.3f} ms (host)" for n, r in res["ops"].items()))
    with tempfile.TemporaryDirectory() as root:
        prefix, splits = write_dataset(root, "ego4d", num_clips=NATIVE_CLIPS, res=(256, 320),
                                       seed=int(rng.integers(1 << 30)))
        train_csv = os.path.join(splits, "train_ego4d_gaze.csv")
        with open(train_csv) as f:
            clips = f.read().splitlines()
        with open(train_csv, "w") as f:
            f.write("\n".join(clips * NATIVE_REPEATS) + "\n")
        cfg = flagship_cfg()
        cfg.DATA.PATH_PREFIX, cfg.DATA.PATH_TO_DATA_DIR = prefix, splits
        cfg.DATA.DECODING_BACKEND = "npy"
        cfg.TRAIN.BATCH_SIZE = 8
        cfg.DATA_LOADER.NUM_WORKERS = NATIVE_WORKERS
        stats = benchmark_data_loading(cfg, NATIVE_BATCHES)
    stats["window_s"] = stats["batches"] / stats["batches_per_sec"]
    log(f"phase classifier loader: benchmark_data_loading {stats['batches']} batches of "
        f"{stats['batch_size']} at {NATIVE_WORKERS} workers over {NATIVE_CLIPS} distinct clips "
        f"(just written, so read from the page cache) in {stats['window_s']:.2f} s: "
        f"{stats['clips_per_sec']:.2f} clips/s, {stats['batches_per_sec']:.3f} batches/s (host, "
        f"{os.cpu_count()} cores)")
    assert stats["batches"] == NATIVE_BATCHES and stats["clips_per_sec"] > 0, stats
    res["benchmark_data_loading"] = stats
    return res


def classifier_phase(rng: np.random.Generator) -> dict:
    """Phase 10: the MViT-B 16x4 classifier family, then the native loader
    ops."""
    t_phase = time.perf_counter()
    res = {tag: classifier_run(cls, rng) for tag, cls in (("cls", True), ("no_cls", False))}
    res["native"] = native_check(rng)
    res["s"] = time.perf_counter() - t_phase
    log(f"phase classifier: {res['s']:.2f} s")
    return res


# --- phase 11: the model axes (two ranks sharing the card) -------------------------
#
# The model, seq and pipe axes of ``csts_torch/parallel`` at full flagship
# width on two gloo ranks sharing the card (NCCL refuses two ranks on one
# device), one axis of 2 at a time in one spawned group: the bf16 eval
# forward at batch 8 against one process (heatmap_check), one fp32 step at
# global batch 2 with drop-path 0.2 and the global masks against one process
# at phase 6's whole-step bars, each rank's launches against the axis's plan,
# each rank's ms a forward and a step (CUDA events); then, on one process,
# the device-list predictor, the preprocessing CLI and the ffmpeg binary.

AX_AXES = ("pipe", "model", "seq")
AX_KW = {"pipe": "pipe_parallel", "model": "model_parallel", "seq": "seq_parallel"}
AX_EVAL_BATCH = 8
AX_TIMED = 2  # timed forwards and steps a rank, after the checked ones
AX_FWD_KERNELS = ("attention", "mlp_tail", "block", "pool_block", "decoder_block",
                  "t2_upsample")
AX_STEP_KERNELS = ("attention", "attention_bwd", "mlp_tail_train", "t2_upsample")
AX_PIPE_BLOCKS = 8  # the flagship's pipelined run: v4-v11 (v12 and v13 differ in dim_out)


def _ax_events_ms(fn, n: int) -> list:
    """``fn``'s ms, ``n`` calls each between two CUDA events."""
    out = []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _ax_pipe_blocks(model, batch: int) -> int:
    """How many video blocks the installed pipe axis runs as a pipeline at
    ``batch`` (the runs ``CSTS.forward`` finds)."""
    from csts_torch.parallel import pipeline

    S = pipeline.pipe_size()
    if S is None or batch % pipeline.effective_microbatches(S):
        return 0
    return sum(n for _, n in model.pipe_runs())


def _ax_step(cfg, sd: dict, batch: dict, drop: list, timed: int, save: str = None,
             ref: str = None) -> dict:
    """One fp32 step of ``make_train_step`` from ``sd`` on this rank's data
    stripe of ``batch`` with the global masks: the stats, every gradient and
    the params after it (whole, on the host; with ``ref``, the path of the
    one process's, only their ``_step_errors`` against it, so that no rank
    ships a copy of the model), the training kernels' launches, what the
    rank holds (its moments' parameters, the split leaves and the shapes of
    their moments, whether every parameter is a DTensor), with ``save`` the
    TrainState saved there (rank 0 writes the npz), then ``timed`` more
    steps' ms."""
    spec = build_spec(cfg)
    state = train_lib.create_train_state(cfg, spec, state_dict=sd, device="cuda")
    step = train_lib.make_train_step(cfg, spec, STEPS_PER_EPOCH)
    lo, rows = mesh.local_rows(batch["video"].shape[0])
    batch = {k: v[lo:lo + rows].cuda() for k, v in batch.items()}
    drop = [None if m is None else tuple(x.cuda() for x in m) for m in drop]
    reset_launches()
    st, _ = step(state, batch, None, drop=drop)
    launches = {n: WRAPPERS[n].launches for n in AX_STEP_KERNELS}
    named = dict(state.model.named_parameters())
    opt = state.optimizer.local
    split = {n: p for n, p in named.items() if getattr(p, "model_split", None) is not None}
    res = {"stats": [{k: float(v) for k, v in st.items()}], "launches": launches,
           "rows": (lo, rows),
           "grads": {n: collectives.whole(p.grad, like=p).detach().float().cpu()
                     for n, p in named.items()},
           "params": {n: collectives.whole(p.detach(), like=p).float().cpu()
                      for n, p in named.items()},
           "split": len(split),
           # the split leaves whose moments this rank keeps, and how many of
           # those moments are split as their leaves are
           "split_kept": sum("exp_avg" in opt.state.get(p, {}) for p in split.values()),
           "split_moments": sum(tuple(opt.state[p]["exp_avg"].shape) == tuple(p.shape)
                                for p in split.values() if "exp_avg" in opt.state.get(p, {})),
           "moments_of": sorted(n for n, p in named.items() if "exp_avg" in opt.state.get(p, {})),
           "all_dtensor": all(isinstance(p, collectives.DTensor) for p in named.values())}
    if ref is not None:
        res["errors"] = _step_errors(res["stats"], res.pop("grads"), res.pop("params"),
                                     torch.load(ref), sum(s_["lr"] for s_ in res["stats"]))
    if save is not None:
        res["npz"] = cu.save_checkpoint(save, state, 0, cfg)
        res["orbax"] = _ax_orbax_save(save, state)
    res["ms"] = _ax_events_ms(lambda: step(state, batch, None, drop=drop), timed)
    return res


def _ax_orbax_save(out: str, state) -> dict:
    """7c (b) on one rank: the TrainState saved as step 1 through the
    orbax backend beside its npz (every rank writes its own pieces): the
    seconds ``save`` blocked and until ``close`` returned, what this rank
    staged and the bytes of its own file."""
    import torch.distributed as dist

    ck = orbax_ckpt.OrbaxCheckpointer(out)
    t = time.perf_counter()
    ck.save(state, 1)
    blocked = time.perf_counter() - t
    ck.close()
    mine = os.path.join(ck.step_dir(1), f"__{dist.get_rank()}_0.distcp")
    return {"out": out, "dir": ck.step_dir(1), "blocked_s": blocked,
            "close_s": time.perf_counter() - t, "staged_bytes": ck.last_save["bytes"],
            "file_bytes": os.path.getsize(mine) if os.path.exists(mine) else 0}


def _ax_orbax_task(rank: int, inputs: str, src: str, npz: str, device: str) -> dict:
    """7c (b) on one of two ranks: DATA=2 under ZeRO-1 (no other axis), the
    state made from the inputs' weights (before the step) restored from the
    DATA=2 x MODEL=2 run's orbax step with ``collectives.whole`` refused (no
    rank gathers), then gathered; rank 0 holds it against that run's npz
    leaf for leaf."""
    cfg = _par_cfg("zero1")
    state = train_lib.create_train_state(cfg, build_spec(cfg), state_dict=torch.load(inputs)["sd"],
                                         device=device)
    ck = orbax_ckpt.OrbaxCheckpointer(src)
    whole, collectives.whole = collectives.whole, _refuse_whole
    t = time.perf_counter()
    try:
        _, step = ck.restore(state)
    finally:
        collectives.whole = whole
    restore_s = time.perf_counter() - t
    ck.close()
    leaves = cu.state_leaves(state)
    res = {"step": step, "restore_s": restore_s}
    if rank == 0:
        res["equal"] = _leaves_equal(leaves, npz)
    return res


def _refuse_whole(*a, **k):
    raise AssertionError("a whole tensor was gathered during a direct-to-shard restore")


def _leaves_equal(leaves: list, npz: str) -> int:
    """The count of ``leaves`` (``state_leaves``), each equal to the npz's
    (dtype and values)."""
    with np.load(npz) as blob:
        want = [blob[k] for k in sorted(blob.files)]
    assert len(leaves) == len(want), (len(leaves), len(want))
    for i, (got, w) in enumerate(zip(leaves, want)):
        assert got.dtype == w.dtype and np.array_equal(got, w), i
    return len(leaves)


def _ax_forward(sd: dict, video, audio, m) -> dict:
    """The bf16 flagship eval forward of ``video``, ``audio`` under mesh
    ``m`` (None: one process): logits on the host, launches, ms."""
    cfg = flagship_cfg()
    cfg.TRAIN.MIXED_PRECISION = True
    model = CSTS(build_spec(cfg))
    model.load_state_dict(sd)
    model = model.to(torch.bfloat16).cuda().eval()
    if m is not None and m.size(mesh.MODEL_AXIS) > 1:
        mesh.split_model(model, m)
    v, a = video.cuda(), audio.cuda()
    reset_launches()
    with torch.inference_mode():
        logits = model(v, a).float().cpu()
        launches = {n: WRAPPERS[n].launches for n in AX_FWD_KERNELS}
        ms = _ax_events_ms(lambda: model(v, a), AX_TIMED)
    return {"logits": logits, "launches": launches, "ms": ms,
            "pipe_blocks": _ax_pipe_blocks(model, video.shape[0])}


def _ax_task(rank: int, inputs: str, ref: str, device: str) -> dict:
    """Phase 11 on one rank of ``spawn_ranks``' group: for each axis, a mesh
    of that axis at 2 installed, the forward and the step; {axis: result}."""
    d = torch.load(inputs)
    res = {}
    for axis in AX_AXES:
        with mesh.use(mesh.make_mesh(**{AX_KW[axis]: 2})) as m:
            fwd = _ax_forward(d["sd"], d["video"], d["audio"], m)
            step = _ax_step(_par_cfg(), d["sd"], d["batch"], d["drop"], AX_TIMED, ref=ref)
            res[axis] = {"forward": fwd, "step": step, "coords": dict(m.coords),
                         "counts": dict(mesh.COUNTS)}
            mesh.COUNTS.clear()
        torch.cuda.empty_cache()
    return res


PAR_TASKS["axes"] = _ax_task

# --- 11e: the axes composed (four ranks sharing the card) ---------------------
#
# SEQ=2 x PIPE=2 (the forward and the step on stripes inside the stages) and
# DATA=2 x MODEL=2 under SOLVER.ZERO1 (the step, each rank's moment share,
# rank 0's npz) on four gloo ranks; SOLVER.FSDP under PIPE=2 and under SEQ=2
# on two gloo ranks whose data axis is a one-rank NCCL group each (gloo
# cannot run DTensor's collectives on CUDA tensors, and NCCL refuses two
# ranks on one device in one group).

AX_WORLD = 4
AX_COMPOSED = {"seq_pipe": ({"seq": 2, "pipe": 2}, "ddp"), "data_model_zero1": ({"model": 2},
                                                                                "zero1")}
AX_FSDP = {"pipe_fsdp": {"pipe": 2}, "seq_fsdp": {"seq": 2}}


def _ax_mesh(axes: dict):
    return mesh.make_mesh(**{AX_KW[a]: n for a, n in axes.items()})


def _ax_compose_task(rank: int, inputs: str, ref: str, root: str, device: str) -> dict:
    """11e on one of AX_WORLD ranks: under each of AX_COMPOSED's meshes the
    step (ZeRO-1's saving its TrainState under ``root``), and under SEQ x
    PIPE the forward too."""
    d = torch.load(inputs)
    res = {}
    for tag, (axes, mode) in AX_COMPOSED.items():
        with mesh.use(_ax_mesh(axes)) as m:
            out = {"coords": dict(m.coords)}
            if tag == "seq_pipe":
                out["forward"] = _ax_forward(d["sd"], d["video"], d["audio"], m)
            out["step"] = _ax_step(_par_cfg(mode), d["sd"], d["batch"], d["drop"], AX_TIMED,
                                   save=os.path.join(root, tag) if mode == "zero1" else None,
                                   ref=ref)
            out["counts"] = dict(mesh.COUNTS)
            mesh.COUNTS.clear()
            res[tag] = out
        torch.cuda.empty_cache()
    return res


def _ax_fsdp_task(rank: int, inputs: str, ref: str, device: str) -> dict:
    """11e's FSDP layouts on one of two ranks: the data axis of each mesh
    (one rank) replaced by a one-rank NCCL group of this rank's own, over
    which FSDP2 shards and gathers; the step under each of AX_FSDP."""
    import torch.distributed as dist

    d = torch.load(inputs)
    nccl = [dist.new_group([r], backend="nccl") for r in range(dist.get_world_size())]
    res = {}
    for tag, axes in AX_FSDP.items():
        m = _ax_mesh(axes)
        m.groups[mesh.DATA_AXIS] = nccl[rank]
        with mesh.use(m):
            res[tag] = {"coords": dict(m.coords), "backend": dist.get_backend(nccl[rank]),
                        "step": _ax_step(_par_cfg("fsdp"), d["sd"], d["batch"], d["drop"],
                                         AX_TIMED, ref=ref),
                        "counts": dict(mesh.COUNTS)}
            mesh.COUNTS.clear()
        torch.cuda.empty_cache()
    return res


PAR_TASKS["axes_compose"] = _ax_compose_task
PAR_TASKS["axes_fsdp"] = _ax_fsdp_task
PAR_TASKS["axes_orbax"] = _ax_orbax_task


def _moment_errors(first: dict, second: dict, grads: dict) -> dict:
    """A TrainState's moments after one Adam step against the one process's
    clipped gradients g (first = 0.1·g, second = 0.001·g²), each at phase
    6's gradient bar carried through (relative norm STEP_GRAD_RTOL plus
    STEP_GRAD_FLOOR of the whole gradient's norm; for the second moment
    times 0.001·2·max|g|): the worst share of its bar."""
    norm = lambda t: float(torch.linalg.vector_norm(t))  # noqa: E731
    total = float(np.sqrt(sum(norm(g) ** 2 for g in grads.values())))
    worst = {"first": 0.0, "second": 0.0}
    for n, g in grads.items():
        gbar = STEP_GRAD_RTOL * norm(g) + STEP_GRAD_FLOOR * total
        worst["first"] = max(worst["first"], norm(first[n].float() - 0.1 * g) / (0.1 * gbar))
        bar2 = 0.001 * 2 * float(g.abs().max()) * gbar + 1e-30
        worst["second"] = max(worst["second"], norm(second[n].float() - 0.001 * g * g) / bar2)
    return worst


def axes_composed(path: str, one_fwd: dict, one_step: dict, ranks: list, franks: list,
                  oranks: list) -> dict:
    """11e: the composed layouts on four ranks (``ranks``) against one
    process, the ZeRO-1 npz loaded into one process; ``franks``: each of two
    ranks' results of the FSDP layouts (run after 11a-c in their group),
    against one process; 7c (b): the ZeRO-1 state's orbax step, each rank's
    bytes, restored into one process and (``oranks``) into DATA=2."""
    from csts_torch.parallel import pipeline
    from csts_torch.tools import check_line, heatmap_check

    res = {}
    mb = pipeline.effective_microbatches(2)
    for tag, (axes, mode) in AX_COMPOSED.items():
        out = res[tag] = {"ranks": []}
        for r, rk in enumerate(ranks):
            got, step = rk[tag], rk[tag]["step"]
            err = step["errors"]
            _check_step_errors(f"11e {tag} rank {r}", err)
            for axis in axes:
                assert got["counts"].get(axis, 0) > 0, (tag, r, got["counts"])
            row = {"coords": got["coords"], "errors": err, "launches_step": step["launches"],
                   "step_ms": step["ms"], "collectives": got["counts"], "rows": step["rows"]}
            line = (f"phase axes 11e {tag} rank {r} {got['coords']}: fp32 step rows "
                    f"{step['rows']} of {PAR_BATCH} vs one process: loss rel err "
                    f"{err['loss_rel_err']:.3g}, worst gradient bar share "
                    f"{err['grad_bar_share_worst']:.3g} ({err['grad_bar_worst_param']}), params "
                    f"max|Δ| {err['param_max_abs_err']:.3g} (bar {err['param_bar']:.3g})")
            if tag == "seq_pipe":
                fwd = got["forward"]
                chk = heatmap_check(fwd["logits"], one_fwd["logits"])
                assert chk["ok"], (tag, r, chk)
                n_pipe = fwd["pipe_blocks"]
                assert n_pipe == AX_PIPE_BLOCKS, n_pipe
                plan_f = _ax_plan("seq_pipe", one_fwd["launches"], n_pipe, n_pipe // 2, mb)
                plan_s = _ax_plan("seq_pipe", one_step["launches"], n_pipe, n_pipe // 2, mb)
                assert fwd["launches"] == plan_f, (tag, r, fwd["launches"], plan_f)
                assert step["launches"] == plan_s, (tag, r, step["launches"], plan_s)
                row.update(check=chk, launches_forward=fwd["launches"], plan_forward=plan_f,
                           plan_step=plan_s, forward_ms=fwd["ms"])
                line += (f"; forward bf16 batch {AX_EVAL_BATCH} vs one process: "
                         f"{check_line(chk)}; launches forward {fwd['launches']} step "
                         f"{step['launches']} (plan met: {n_pipe} pipelined blocks, "
                         f"{n_pipe // 2} a stage, M={mb}, K1 and the tail on each stripe)")
            else:
                partner = next(o[tag]["step"] for o in ranks
                               if o[tag]["coords"]["model"] == got["coords"]["model"]
                               and o[tag]["coords"]["data"] != got["coords"]["data"])
                mine, theirs = set(step["moments_of"]), set(partner["moments_of"])
                assert mine and not mine & theirs and mine | theirs == set(one_step["grads"]), tag
                assert step["split"] > 0 and step["split_moments"] == step["split_kept"], step
                assert step["split_kept"] + partner["split_kept"] == step["split"], tag
                row.update(moments_held=len(mine), split_leaves=step["split"],
                           split_moments_held=step["split_moments"])
                line += (f"; ZeRO-1 moments of {len(mine)} of {len(one_step['grads'])} parameters "
                         f"(the data partner {len(theirs)}, disjoint), {step['split']} split "
                         f"leaves, {step['split_moments']} of whose moments it keeps, split")
            line += f"; collectives {got['counts']}"
            out["ranks"].append(row)
            log(line)
            log(f"phase axes 11e {tag} rank {r} timing (four ranks sharing one card over "
                f"gloo, not a scaling figure): "
                + (f"forward ms {[round(x, 2) for x in got['forward']['ms']]}, "
                   if tag == "seq_pipe" else "")
                + f"step ms {[round(x, 2) for x in step['ms']]} (CUDA events) ({CARD})")
    # rank 0's ZeRO-1 npz: the one-process TrainState, whole
    npz = ranks[0]["data_model_zero1"]["step"]["npz"]
    assert all(rk["data_model_zero1"]["step"].get("npz") == npz for rk in ranks)
    cfg = _par_cfg()
    state = train_lib.create_train_state(cfg, build_spec(cfg), state_dict=torch.load(path)["sd"],
                                         device="cuda")
    cu.load_checkpoint(npz, state)
    params = {n: p.detach().float().cpu() for n, p in state.model.named_parameters()}
    count, first, second = state.optimizer.moments()
    first, second = ({n: t.float().cpu() for n, t in d.items()} for d in (first, second))
    lr = ranks[0]["data_model_zero1"]["step"]["stats"][0]["lr"]
    perr = max(float((params[n] - p).abs().max()) for n, p in one_step["params"].items())
    merr = _moment_errors(first, second, one_step["grads"])
    assert state.step == 1 and count == 1, (state.step, count)
    assert perr <= 2 * lr and merr["first"] <= 1.0 and merr["second"] <= 1.0, (perr, merr)
    res["zero1_npz"] = {"path_leaves": len(np.load(npz).files), "param_max_abs_err": perr,
                        "param_bar": 2 * lr, "moment_bar_share_worst": merr}
    log(f"phase axes 11e data_model_zero1 npz: rank 0's TrainState ({res['zero1_npz']['path_leaves']}"
        f" leaves) loaded into one process on the card: step {state.step}, Adam count {count}, "
        f"params max|Δ| {perr:.3g} vs the one-process step (bar {2 * lr:.3g}), moments' worst "
        f"bar share first {merr['first']:.3g} second {merr['second']:.3g}")
    del state, params, first, second
    torch.cuda.empty_cache()
    res["orbax"] = _ax_orbax_checks(path, ranks, oranks, npz)

    for tag, axes in AX_FSDP.items():
        out = res[tag] = {"ranks": []}
        for r, rk in enumerate(franks):
            got, step = rk[tag], rk[tag]["step"]
            err = step["errors"]
            _check_step_errors(f"11e {tag} rank {r}", err)
            assert step["all_dtensor"], (tag, r)
            for axis in axes:
                assert got["counts"].get(axis, 0) > 0, (tag, r, got["counts"])
            out["ranks"].append({"coords": got["coords"], "errors": err,
                                 "launches_step": step["launches"], "step_ms": step["ms"],
                                 "collectives": got["counts"], "data_backend": got["backend"]})
            log(f"phase axes 11e {tag} rank {r} {got['coords']}: SOLVER.FSDP over a one-rank "
                f"{got['backend']} data group, the {'/'.join(axes)} axis over gloo: fp32 step vs "
                f"one process: loss rel err {err['loss_rel_err']:.3g}, worst gradient bar share "
                f"{err['grad_bar_share_worst']:.3g} ({err['grad_bar_worst_param']}), params "
                f"max|Δ| {err['param_max_abs_err']:.3g} (bar {err['param_bar']:.3g}); every "
                f"parameter a DTensor after the step; launches {step['launches']}; collectives "
                f"{got['counts']}")
            log(f"phase axes 11e {tag} rank {r} timing (two ranks sharing one card, not a "
                f"scaling figure): step ms {[round(x, 2) for x in step['ms']]} (CUDA events) "
                f"({CARD})")
    return res


def _ax_orbax_checks(path: str, ranks: list, oranks: list, npz: str) -> dict:
    """7c (b): DATA=2 x MODEL=2 under ZeRO-1 saved through the orbax backend
    on four ranks: each rank's bytes (none the whole state); the step
    restored into one process on the card and into DATA=2 on two ranks
    (``oranks``), each equal to rank 0's npz of the same state leaf for
    leaf."""
    saves = [rk["data_model_zero1"]["step"]["orbax"] for rk in ranks]
    step_dir = saves[0]["dir"]
    files = {n: os.path.getsize(os.path.join(step_dir, n)) for n in os.listdir(step_dir)}
    total = sum(b for n, b in files.items() if n.endswith(".distcp"))
    mine = [sv["file_bytes"] for sv in saves]
    assert all(0 < b < total for b in mine), (mine, total)
    cfg = _par_cfg("zero1")
    state = train_lib.create_train_state(cfg, build_spec(cfg), state_dict=torch.load(path)["sd"],
                                         device="cuda")
    ck = orbax_ckpt.OrbaxCheckpointer(saves[0]["out"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, step = ck.restore(state)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t
    ck.close()
    n_one = _leaves_equal(cu.state_leaves(state), npz)
    assert step == 1 and all(o["step"] == 1 for o in oranks), (step, oranks)
    n_two = oranks[0]["equal"]
    res = {"files": files, "rank_bytes": mine, "total_bytes": total,
           "staged_bytes": [sv["staged_bytes"] for sv in saves],
           "blocked_s": [sv["blocked_s"] for sv in saves],
           "close_s": [sv["close_s"] for sv in saves], "one_process_restore_s": one_s,
           "data2_restore_s": [o["restore_s"] for o in oranks], "leaves": n_one}
    def seq(values, scale=1.0):
        return ", ".join(f"{v / scale:.3f}" for v in values)

    log(f"phase axes 11e data_model_zero1 orbax (7c b): each rank wrote its own pieces, ranks "
        f"0-3 {seq(mine, 1e9)} GB of {total / 1e9:.3f} GB on disk (staged "
        f"{seq(res['staged_bytes'], 1e9)} GB; save blocked {seq(res['blocked_s'])} s, closed "
        f"after {seq(res['close_s'])} s); restored into one process on the card in "
        f"{one_s:.3f} s and into DATA=2 under ZeRO-1 on two ranks in "
        f"{seq(res['data2_restore_s'])} s with collectives.whole refused, each equal to rank "
        f"0's npz leaf for leaf ({n_one} and {n_two} leaves) ({CARD})")
    del state
    torch.cuda.empty_cache()
    return res


def _ax_plan(axis: str, one: dict, n_pipe: int, per_stage: int, microbatches: int) -> dict:
    """Each kernel's launches a rank: one process's, except under the pipe
    axis (``axis`` names it, alone or with others), where each of the
    ``n_pipe`` pipelined blocks' launches leave and the rank's own
    ``per_stage`` blocks run once a microbatch (on the seq axis's stripes
    too: a stripe's block launches K1 and its tail once)."""
    if "pipe" not in axis:
        return dict(one)
    per_block = {"attention": 1, "mlp_tail": 1, "attention_bwd": 1, "mlp_tail_train": 1}
    return {n: c - per_block.get(n, 0) * (n_pipe - per_stage * microbatches)
            for n, c in one.items()}


def axes_phase(rng: np.random.Generator) -> dict:
    """Phase 11: 11a-c, the three axes on two ranks sharing the card
    against one process; 11d on one process."""
    from csts_torch.parallel import pipeline
    from csts_torch.tools import check_line, heatmap_check

    t_phase = time.perf_counter()
    cfg = _par_cfg()
    spec = build_spec(cfg)
    model = CSTS(spec)
    init_params(model, torch.Generator().manual_seed(SEED + 7))
    video, audio = make_inputs(rng, AX_EVAL_BATCH, spec)
    inputs = {"sd": {k: v.detach().clone() for k, v in model.state_dict().items()},
              "video": torch.from_numpy(video), "audio": torch.from_numpy(audio),
              "batch": _par_batch(rng, PAR_BATCH, spec),
              "drop": sample_drop_masks(spec.video_blocks, PAR_BATCH,
                                        torch.Generator().manual_seed(SEED + 13), "cpu")}
    del model
    res = {}
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "inputs.pt")
        torch.save(inputs, path)
        t0 = time.perf_counter()
        one_fwd = _ax_forward(inputs["sd"], inputs["video"], inputs["audio"], None)
        one_step = _ax_step(cfg, inputs["sd"], inputs["batch"], inputs["drop"], AX_TIMED)
        torch.cuda.empty_cache()
        res["one_process"] = {"forward_ms": one_fwd["ms"], "step_ms": one_step["ms"],
                              "launches_forward": one_fwd["launches"],
                              "launches_step": one_step["launches"],
                              "s": time.perf_counter() - t0}
        log(f"phase axes one process: forward bf16 batch {AX_EVAL_BATCH} "
            f"{_ms(float(np.median(one_fwd['ms'])))} ms, fp32 step batch {PAR_BATCH} "
            f"{_ms(float(np.median(one_step['ms'])))} ms (CUDA events, medians of {AX_TIMED}); "
            f"launches forward {one_fwd['launches']}, step {one_step['launches']} ({CARD})")
        ref_path = os.path.join(root, "ref.pt")
        torch.save({k: one_step[k] for k in ("stats", "grads", "params")}, ref_path)
        # 11e's four ranks first: their ZeRO-1 state's orbax step is restored
        # in the two-rank group (7c b), which then runs 11a-c and 11e's FSDP
        t0 = time.perf_counter()
        four = [rk["axes_compose"] for rk in spawn_ranks(
            [("axes_compose", (path, ref_path, root))], root, "cuda", world=AX_WORLD)]
        res["four_ranks_s"] = time.perf_counter() - t0
        zero1 = four[0]["data_model_zero1"]["step"]
        t0 = time.perf_counter()
        both = spawn_ranks([("axes_orbax", (path, zero1["orbax"]["out"], zero1["npz"])),
                            ("axes", (path, ref_path)), ("axes_fsdp", (path, ref_path))], root,
                           "cuda")
        ranks, fsdp_ranks = [rk["axes"] for rk in both], [rk["axes_fsdp"] for rk in both]
        res["ranks_s"] = time.perf_counter() - t0
        for tag, axis in zip("abc", AX_AXES):
            out = res[axis] = {"ranks": []}
            for r, rk in enumerate(ranks):
                got = rk[axis]
                fwd, step = got["forward"], got["step"]
                chk = heatmap_check(fwd["logits"], one_fwd["logits"])
                assert chk["ok"], (axis, r, chk)
                err = step["errors"]
                _check_step_errors(f"{axis} rank {r}", err)
                n_pipe = fwd["pipe_blocks"] if axis == "pipe" else 0
                per_stage, mb = n_pipe // 2, pipeline.effective_microbatches(2)
                plan_f = _ax_plan(axis, one_fwd["launches"], n_pipe, per_stage, mb)
                plan_s = _ax_plan(axis, one_step["launches"], n_pipe, per_stage, mb)
                assert fwd["launches"] == plan_f, (axis, r, fwd["launches"], plan_f)
                assert step["launches"] == plan_s, (axis, r, step["launches"], plan_s)
                assert got["counts"].get(axis, 0) > 0, (axis, r, got["counts"])
                if axis == "pipe":
                    assert n_pipe == AX_PIPE_BLOCKS, n_pipe
                if axis == "model":
                    assert step["split"] > 0 and step["split_moments"] == step["split"], step
                out["ranks"].append({
                    "check": chk, "errors": err, "launches_forward": fwd["launches"],
                    "launches_step": step["launches"], "plan_forward": plan_f,
                    "plan_step": plan_s, "forward_ms": fwd["ms"], "step_ms": step["ms"],
                    "coords": got["coords"], "collectives": got["counts"],
                    "split_leaves": step["split"], "pipe_blocks": n_pipe})
                log(f"phase axes 11{tag} {axis}=2 rank {r}: forward bf16 batch {AX_EVAL_BATCH} "
                    f"vs one process: {check_line(chk)}; fp32 step batch {PAR_BATCH} vs one "
                    f"process: loss rel err {err['loss_rel_err']:.3g}, worst gradient bar share "
                    f"{err['grad_bar_share_worst']:.3g} ({err['grad_bar_worst_param']}), "
                    f"params max|Δ| "
                    f"{err['param_max_abs_err']:.3g} (bar {err['param_bar']:.3g}); launches "
                    f"forward {fwd['launches']} step {step['launches']} (plan met"
                    + (f": {n_pipe} pipelined blocks, {per_stage} a stage, M={mb}" if n_pipe
                       else "") + f"); collectives {got['counts']}"
                    + (f"; {step['split']} split leaves, their moments split"
                       if axis == "model" else ""))
                log(f"phase axes 11{tag} {axis}=2 rank {r} timing (two ranks sharing one "
                    f"card, not a scaling figure): forward ms {[round(x, 2) for x in fwd['ms']]}"
                    f", step ms {[round(x, 2) for x in step['ms']]} (CUDA events) ({CARD})")
        res["d"] = axes_one_process(root, inputs)
        t0 = time.perf_counter()
        res["e"] = axes_composed(path, one_fwd, one_step, four, fsdp_ranks,
                                 [rk["axes_orbax"] for rk in both])
        res["e"]["ranks_s"] = res.pop("four_ranks_s")
        res["e"]["s"] = res["e"]["ranks_s"] + time.perf_counter() - t0
        log(f"phase axes 11e: {res['e']['s']:.2f} s (its four ranks and checks)")
    res["s"] = time.perf_counter() - t_phase
    log(f"phase axes: {res['s']:.2f} s")
    return res


def axes_one_process(root: str, inputs: dict) -> dict:
    """11d: ``GazePredictor(devices=[cuda:0])`` against the plain predictor
    at buckets 1 and 8 (eager, capture, replay: bit-equal); the
    preprocessing CLI's ``splits`` and ``check`` over a synthetic split;
    whether an ffmpeg binary is present."""
    import subprocess

    from csts_torch.data.synthetic import write_dataset

    cfg = flagship_cfg()
    cfg.TRAIN.MIXED_PRECISION = True
    plain = GazePredictor(cfg, inputs["sd"], batch_sizes=(1, 8))
    listed = GazePredictor(cfg, inputs["sd"], batch_sizes=(1, 8), devices=["cuda:0"])
    v, a = inputs["video"].numpy(), inputs["audio"].numpy()
    equal = {}
    for n in (1, 8):
        for turn in range(3):  # eager, capture, replay
            want = plain.predict(v[:n], a[:n])["heatmaps"]
            got = listed.predict(v[:n], a[:n])["heatmaps"]
            equal[f"{n}/{turn}"] = bool(np.array_equal(got, want))
    assert all(equal.values()), equal
    graphs = sorted(b for b, slot in listed._replicas[0]._slots.items() if slot.graph is not None)
    log(f"phase axes 11d serving: GazePredictor(devices=[cuda:0]) buckets 1 and 8, three "
        f"requests each (eager, capture, replay), bit-equal to the plain predictor: {equal}; "
        f"graphs captured for buckets {graphs}")
    del plain, listed
    torch.cuda.empty_cache()

    prefix, splits = write_dataset(os.path.join(root, "pre"), "ego4d", num_clips=4,
                                   res=(64, 80), seed=SEED)
    env = dict(os.environ, PYTHONPATH=ROOT)
    cli = [sys.executable, "-m", "csts_torch.data.preprocess"]
    chk = subprocess.run(cli + ["check", "--prefix", prefix, "--data-dir", splits, "--dataset",
                                "ego4d_av_gaze_forecast"], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert chk.returncode == 0, chk.stdout + chk.stderr
    out_dir = os.path.join(root, "pre_splits")
    spl = subprocess.run(cli + ["splits", "--clips", prefix, "--output", out_dir, "--dataset",
                                "ego4d", "--test-fraction", "0.5"], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert spl.returncode == 0, spl.stdout + spl.stderr
    made = sorted(os.listdir(out_dir))
    assert made == ["ego4d_video_ids.txt", "test_ego4d_gaze.csv", "train_ego4d_gaze.csv"], made
    ffmpeg = shutil.which("ffmpeg")
    log(f"phase axes 11d preprocess: check over {prefix} -> rc 0 ({chk.stderr.strip()}); "
        f"splits -> {made} ({spl.stderr.strip()}); ffmpeg binary: "
        + (ffmpeg if ffmpeg else "absent (trim and audio raise without it, as JAX's do; "
                                 "not a caught failure)"))
    return {"serving_bit_equal": equal, "graphs": graphs, "check": chk.stderr.strip(),
            "splits": made, "ffmpeg": ffmpeg}


def axes_only(t_start: float, audit: ProcessAudit) -> int:
    """``--axes``: the build, then phase 11 alone (its JSON to
    ``chiprun_out/chip_smoke_axes.json``), then the card and result lines."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase build: {time.perf_counter() - t_start:.2f} s")
    audit.at("axes")
    res = axes_phase(np.random.default_rng(SEED))
    res["processes"] = close_run(audit)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_axes.json"), "w") as f:
        json.dump({"card": CARD, "axes": res}, f, indent=1, default=str)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def trainer_only(t_start: float, audit: ProcessAudit) -> int:
    """``--trainer``: the build, then phase 7 (7c included) alone (its JSON
    to ``chiprun_out/chip_smoke_trainer.json``), then the card and result
    lines."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase build: {time.perf_counter() - t_start:.2f} s")
    audit.at("trainer")
    t0 = time.perf_counter()
    res = trainer_phase(np.random.default_rng(SEED))
    log(f"phase trainer total: {time.perf_counter() - t0:.2f} s")
    res["processes"] = close_run(audit)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_trainer.json"), "w") as f:
        json.dump({"card": CARD, "trainer": res}, f, indent=1, default=str)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def switches_only(t_start: float, audit: ProcessAudit) -> int:
    """``--switches``: the build, then phase 5b alone (its JSON to
    ``chiprun_out/chip_smoke_switches.json``), then the card and result
    lines."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase build: {time.perf_counter() - t_start:.2f} s")
    audit.at("switches")
    t0 = time.perf_counter()
    res = switches_phase(np.random.default_rng(SEED))
    log(f"phase switches: {time.perf_counter() - t0:.2f} s")
    res["processes"] = close_run(audit)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_switches.json"), "w") as f:
        json.dump({"card": CARD, "switches": res}, f, indent=1, default=str)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def parallel_only(t_start: float, audit: ProcessAudit) -> int:
    """``--parallel``: the build, then phase 8 alone (its JSON to
    ``chiprun_out/chip_smoke_parallel.json``), then the card and result
    lines."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase build: {time.perf_counter() - t_start:.2f} s")
    audit.at("parallel")
    res = parallel_phase(np.random.default_rng(SEED))
    res["processes"] = close_run(audit)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_parallel.json"), "w") as f:
        json.dump({"card": CARD, "parallel": res}, f, indent=1, default=str)
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    global CARD
    t_start = time.perf_counter()
    audit = ProcessAudit()
    card = CARD = card_line()
    log(f"card: {card}")
    if sys.argv[1:] == ["--determinism"]:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before cuBLAS starts
    log(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}")
    if sys.argv[1:] == ["--determinism"]:
        return determinism_probe(audit)

    # --- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    if sys.argv[1:] == ["--parallel"]:
        return parallel_only(t0, audit)
    if sys.argv[1:] == ["--axes"]:
        return axes_only(t0, audit)
    if sys.argv[1:] == ["--trainer"]:
        return trainer_only(t0, audit)
    if sys.argv[1:] == ["--switches"]:
        return switches_only(t0, audit)
    if sys.argv[1:] == ["--conditioning"]:
        return conditioning_probe(t0, audit)
    log(f"phase build: {time.perf_counter() - t0:.2f} s for {sorted(logs)}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Potential Performance Loss" in line:
                log(f"  {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- phase 1b: the repaired widths ----------------------------------------
    audit.at("widths")
    t0 = time.perf_counter()
    widths = widths_phase()
    log(f"phase widths: {time.perf_counter() - t0:.2f} s")

    # --- phase 2: flagship model behind the predictor ------------------------
    audit.at("model")
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
    audit.at("kernels")
    t0 = time.perf_counter()
    with torch.inference_mode():
        report = check_kernels(calls_by_bucket)
    del calls_by_bucket
    log(f"phase kernels: {time.perf_counter() - t0:.2f} s")

    # --- phase 4: the serving path -------------------------------------------
    audit.at("serve")
    # Each bucket ran its first request eagerly in phase 2: the requests of 1
    # and 5 clips now capture the graphs of buckets 1 and 8 (the wrappers
    # count their launches as they are captured), the request of 8 replays.
    requests = [make_inputs(rng, n, spec) for n in REQUESTS]
    reset_launches()
    outs = [pred.predict(video, audio) for video, audio in requests]
    launches = {name: WRAPPERS[name].launches for name in PER_FORWARD}
    log(f"phase serve: requests {list(REQUESTS)} (graphs captured for buckets "
        f"{sorted(b for b, slot in pred._slots.items() if slot.graph is not None)}); "
        f"launches {launches}")
    captures = 2
    for name, per in PER_FORWARD.items():
        need = per * captures
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

    t0 = time.perf_counter()
    serving = serve_phase(pred, spec, rng, requests, outs)
    log(f"phase serve total: {time.perf_counter() - t0:.2f} s")

    with torch.inference_mode():
        fwd_ms = time_ms(lambda: pred.forward(v, a), target_s=1.0)
    torch.cuda.reset_peak_memory_stats()
    pred.forward(v, a)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    breakdown = profile_forward(lambda: pred.forward(v, a), fwd_ms, log=log)
    log(f"phase timing: forward batch 8 bf16 {fwd_ms:.2f} ms = {8e3 / fwd_ms:.2f} clips/s, "
        f"peak memory {peak_gib:.2f} GiB ({card})")
    dispatch = dispatch_ab(pred, rng, spec)

    # --- phase 4b: the hw2 path (ab_flags' hw2_skip) under the same predictor -
    audit.at("hw2")
    t0 = time.perf_counter()
    hw2 = hw2_phase(pred, v, a)
    log(f"phase hw2: {time.perf_counter() - t0:.2f} s")
    del pred, v, a
    torch.cuda.empty_cache()

    # --- phase 4c: the blocks path (ab_block's stacks) ------------------------
    audit.at("blocks")
    t0 = time.perf_counter()
    blocks = blocks_phase()
    log(f"phase blocks: {time.perf_counter() - t0:.2f} s")

    # --- phase 4d: the eval entry point (tester.test) on a synthetic split ----
    audit.at("eval")
    t0 = time.perf_counter()
    evals = eval_phase(rng)
    log(f"phase eval total: {time.perf_counter() - t0:.2f} s")

    # --- phase 5: the training path ------------------------------------------
    audit.at("train")
    t0 = time.perf_counter()
    train = train_path(rng)
    log(f"phase train total: {time.perf_counter() - t0:.2f} s")

    # --- phase 6: training kernels against their plain versions --------------
    audit.at("train checks")
    t0 = time.perf_counter()
    train_report = check_train_kernels(train.pop("calls"))
    # the fp32 step of phase 6b, and the same step under the switches of 5b(b)
    steps = whole_step_check(rng, (("default", {}),) + SWITCH_STEP_COMBOS)
    whole_step = steps.pop("default")
    log(f"phase train checks: {time.perf_counter() - t0:.2f} s")

    # --- phase 5b: the JAX package's kernel switches ----------------------------
    audit.at("switches")
    t0 = time.perf_counter()
    switches = switches_phase(rng, steps)
    log(f"phase switches: {time.perf_counter() - t0:.2f} s")

    # --- phase 7: the training entry point (run_net's train mode) -------------
    audit.at("trainer")
    t0 = time.perf_counter()
    trainer = trainer_phase(rng)
    log(f"phase trainer total: {time.perf_counter() - t0:.2f} s")

    # --- phase 8: several processes (two ranks sharing the card) --------------
    audit.at("parallel")
    parallel = parallel_phase(rng)

    # --- phase 9: the forward's whole surface ----------------------------------
    audit.at("surface")
    surface = surface_phase(rng, audit)

    # --- phase 10: the MViT-B 16x4 classifier, the native loader ops ------------
    audit.at("classifier")
    classifier = classifier_phase(rng)

    # --- phase 11: the model axes (two ranks sharing the card), serving over a
    # device list, the preprocessing CLI ----------------------------------------
    audit.at("axes")
    axes = axes_phase(rng)
    log(f"phase axes 11d tensorboard: phase 7's second run with TENSORBOARD.ENABLE wrote "
        f"{trainer['tensorboard']}")

    # the classifier's launches a forward and device ms a forward, at batch 8
    # with the cls token (the published MViT-B 16x4) and without it
    cls_launches = {tag: classifier[tag]["batches"][max(CLASSIFIER_BATCHES)]["launches"]
                    for tag in ("cls", "no_cls")}

    def classifier_device(tag: str, name: str):
        per = classifier[tag]["per_forward"].get(name)
        return per["device_ms"] if per else None

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
        per = lambda key: _total(rows, key, count)  # noqa: E731
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
            # phase 5b: launches a training step under TRAIN_DECODER and
            # with TRAIN_ATTN off
            **switch_launches(switches, name),
            # phase 10: launches and device ms a batch-8 classifier forward
            "launches_classifier": cls_launches["cls"].get(name, 0),
            "launches_classifier_no_cls": cls_launches["no_cls"].get(name, 0),
            "classifier_device_ms": classifier_device("cls", name),
            "classifier_no_cls_device_ms": classifier_device("no_cls", name),
        })
    for name, k in B9_KERNELS.items():
        res = {"hw2_upsample": hw2, "block_multihead": blocks}[name]
        rows = res["shapes"]
        per = lambda key: _total(rows, key, "launches_per_forward")  # noqa: E731
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
            **switch_launches(switches, name),
            # the stacks through this kernel and through the K1+K2 route:
            # CUDA events, and the device's busy time (torch.profiler)
            "block_ms": res.get("block_ms"), "composite_ms": res.get("composite_ms"),
            "block_device_ms": res.get("block_device_ms"),
            "composite_device_ms": res.get("composite_device_ms"),
            "launches_classifier": 0, "launches_classifier_no_cls": 0,
            "classifier_device_ms": None, "classifier_no_cls_device_ms": None,
        })
    # yardsticks beside the kernels: cuBLAS's products alone at K2's and B7's
    # sites, SDPA's backward at B8's, B3's and B4's blocks against the same
    # blocks through the K1+K2 route, F.interpolate at B9a's (device ms)
    k2_rows = [r for r in report["mlp_tail"]["shapes"] if "ms" in r]
    b7_rows = train_report["mlp_tail_train"]["shapes"]
    b8_rows = train_report["attention_bwd"]["shapes"]
    b4_rows = [r for r in report["pool_block"]["shapes"] if "ms" in r]
    b3_rows = [r for r in report["block"]["shapes"] if "ms" in r]
    tot = _total
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
    log("yardsticks: K2 {k2_cublas_ms} ms cuBLAS products a forward (device "
        "{k2_cublas_device_ms}); B7 {b7_cublas_ms} a step (device {b7_cublas_device_ms}); "
        "B8 device {b8_device_ms} vs SDPA backward device {b8_sdpa_bwd_device_ms} a step; "
        "B3 device {b3_device_ms} a forward, its blocks {b3_block_device_ms} vs the same "
        "blocks through the K1+K2 route {b3_k1k2_route_device_ms} (device, phase 1 included); "
        "B4 device {b4_device_ms} a forward, its blocks {b4_block_device_ms} vs the same "
        "blocks through the K1+K2 route {b4_k1k2_route_device_ms} (device, phase 1 included); "
        "B9a device {b9a_device_ms} vs F.interpolate device {b9a_interpolate_device_ms} "
        "a forward with hw2_skip".format(**{k: _ms(v) for k, v in yardsticks.items()})
        + f" ({card})")
    processes = close_run(audit)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "per_shape": report,
                   "forward_ms_batch8": fwd_ms, "clips_per_s_batch8": 8e3 / fwd_ms,
                   "serving": serving, "dispatch": dispatch,
                   "peak_gib": peak_gib, "logits_max_abs_diff": dlogit,
                   "softmax_max_abs_diff": dsm, "profile": breakdown,
                   "hw2": hw2, "blocks": blocks, "yardsticks": yardsticks,
                   "train": train, "train_per_shape": train_report,
                   "train_fp32_step": whole_step, "switches": switches, "widths": widths,
                   "eval": evals,
                   "trainer": trainer, "parallel": parallel, "surface": surface,
                   "classifier": classifier, "axes": axes, "processes": processes,
                   "profiler_windows": PROFILER_WINDOWS}, f, indent=1,
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

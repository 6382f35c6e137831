"""Offline eval: batches of clips back to back through the port's eval entry,
as a user scoring a dataset runs them.

CSTS: ``csts_torch.train.step.make_eval_step`` (the bf16 forward and the
per-frame softmax at T = 2); the MViT classifier: the module's eval forward
(its logits). The inputs are a seeded pool of ``traffic.pool`` batches of
``traffic.batch`` clips on the card, used in turn. The window runs calls
until ``--seconds`` have passed, and each pool batch once at least, and ends
in a synchronise; the rate is all
clips over all that time. With ``--trace 1`` the middle ``traffic.trace_calls``
calls run under the profiler.

The check: once the window has closed, the last output of each pool batch
is kept, a sample of ``traffic.check_clips`` clips drawn from the seed is
taken from them, the program is freed, and the fp32 reference runs over
those clips from the same weights and inputs: the worst frame's total
variation distance of the heatmaps (CSTS), or the worst clip's logit gap
(the classifier).
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from benchmark import counts, program, trace, traffic, weights
from benchmark.reference import arch as ref_arch
from benchmark.reference import lowp, models


def _model(run, cfg, dtype):
    """The program's model at eval with the seed's weights, and its call."""
    keys, dev = run.keys, run.device
    if run.config["model"] == "CSTS":
        from csts_torch.models.csts import CSTS, build_spec
        from csts_torch.train.step import make_eval_step

        spec = build_spec(cfg)
        with dev:
            model = CSTS(spec)
        pspec = models.csts_params(ref_arch.csts_arch(keys))
        step = make_eval_step(cfg, spec)

        def call(batch):
            return step(model, batch)
    else:
        from csts_torch.models.mvit_classifier import MViT, build_mvit_spec

        with dev:
            model = MViT(build_mvit_spec(cfg))
        pspec = models.mvit_params(ref_arch.mvit_arch(keys))

        def call(batch):
            with torch.inference_mode():
                return model(batch["video"])
    model.to(device=dev, dtype=dtype)
    model.load_state_dict(weights.make(run.seed, pspec, dev, dtype), strict=True)
    model.eval()
    return model, call


def setup(run) -> Dict:
    keys, tr, dev = run.keys, run.cell["traffic"], run.device
    dtype = program.compute_dtype(keys)
    cfg = program.program_cfg(keys)
    model, call = _model(run, cfg, dtype)
    run.mark("model with its weights")
    gen = traffic.generator(run.seed, "inputs", dev)
    csts = run.config["model"] == "CSTS"
    pool = [traffic.clips(tr["batch"], keys["DATA.NUM_FRAMES"], keys["DATA.TRAIN_CROP_SIZE"],
                          keys.get("DATA.AUDIO_FREQ_BINS", 0), keys.get("DATA.AUDIO_WINDOW", 0),
                          gen, dtype, audio=csts)
            for _ in range(tr["pool"])]
    run.mark("inputs")
    for i in range(tr.get("warmup_calls", 3)):
        call(pool[0])
        run.mark(f"warm-up call {i + 1}")
    if csts:
        flops = counts.csts_forward_flops(ref_arch.csts_arch(keys))
    else:
        flops = counts.mvit_forward_flops(ref_arch.mvit_arch(keys))
    return {"model": model, "call": call, "pool": pool, "flops_per_clip": flops}


def window(run, st) -> Dict:
    tr, dev = run.cell["traffic"], run.device
    call, pool, batch = st["call"], st["pool"], tr["batch"]
    outs: List = [None] * len(pool)
    calls = 0

    def one():
        nonlocal calls
        outs[calls % len(pool)] = call(pool[calls % len(pool)])
        calls += 1

    summary, traced_calls, traced_s = None, 0, 0.0
    program.sync(dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds or calls < len(pool):  # each batch served
        if run.trace and summary is None and time.perf_counter() - t0 >= run.seconds / 2:
            summary, traced_calls, traced_s = trace.traced_calls(one, tr["trace_calls"])
            continue
        one()
    program.sync(dev)
    elapsed = time.perf_counter() - t0
    st["outs"] = outs
    ctx = {"clips": calls * batch, "window_s": elapsed, "attempted": calls * batch, "failed": 0,
           "memory_peak_bytes": program.peak_bytes(dev), "flops_per_clip": st["flops_per_clip"],
           "untraced_clips": (calls - traced_calls) * batch, "untraced_s": elapsed - traced_s,
           "eval": True}
    if summary is not None:
        ctx["trace"] = summary
    return ctx


def reference_outputs(run, video, audio, rd=None) -> torch.Tensor:
    """The reference's per-frame heatmaps (CSTS) or logits (classifier) of
    the clips, fp32, from the seed's weights as served, in chunks."""
    keys, dev = run.keys, run.device
    chunk = run.cell["traffic"].get("check_chunk", 4)
    rd = rd or models.ident
    with torch.no_grad():
        if run.config["model"] == "CSTS":
            a = ref_arch.csts_arch(keys)
            P = {k: v.float() for k, v in weights.make(
                run.seed, models.csts_params(a), dev, program.compute_dtype(keys)).items()}
            return torch.cat([models.frame_softmax(models.csts_forward(
                P, a, video[i:i + chunk].float(), audio[i:i + chunk].float(), rd=rd))
                for i in range(0, video.shape[0], chunk)])
        a = ref_arch.mvit_arch(keys)
        P = {k: v.float() for k, v in weights.make(
            run.seed, models.mvit_params(a), dev, program.compute_dtype(keys)).items()}
        return torch.cat([models.mvit_forward(P, a, video[i:i + chunk].float(), rd=rd)
                          for i in range(0, video.shape[0], chunk)])


def check(run, st, ctx, controls=()) -> List[Dict]:
    """The readings of the program's outputs; ``controls`` ("fp8"): also
    those of the reference run in fp8 in the program's place, by
    ``reading`` name + "." + control."""
    tr = run.cell["traffic"]
    b = tr["batch"]
    idx = traffic.sample(len(st["pool"]) * b, tr["check_clips"], run.seed)
    csts = run.config["model"] == "CSTS"
    video = torch.stack([st["pool"][i // b]["video"][i % b] for i in idx])
    audio = torch.stack([st["pool"][i // b]["audio"][i % b] for i in idx]) if csts else None
    served = torch.stack([st["outs"][i // b][i % b] for i in idx]).float()
    st.clear()
    program.free(run.device)
    program.reference_mode()
    ref = reference_outputs(run, video, audio)
    gap = program.heatmap_gap if csts else program.logit_gap
    name = "heatmap_tv" if csts else "logit_gap"
    out = [{"name": name, "value": gap(served, ref)}]
    if "fp8" in controls:
        low = reference_outputs(run, video, audio, lowp.fp8)
        out.append({"name": name + ".fp8", "value": gap(low, ref)})
    return out

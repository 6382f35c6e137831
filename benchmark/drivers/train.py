"""Training: the port's training step (``csts_torch.train.step.make_train_step``
over ``create_train_state``: bf16 compute over fp32 master weights, kldiv +
LOSS_ALPHA·EgoNCE, the clip and AdamW) stepped back to back, as a user
fine-tuning runs it, on its default kernel route.

The inputs are a seeded pool of ``traffic.pool`` batches on the card (clips,
Gaussian gaze labels) with their stochastic-depth factors drawn from the
seed and handed to the step. Set-up builds the one training state and drives
it through its first ``traffic.check_steps`` steps (the pool's first
batches, rows that all differ), which also warm up every shape; the window
then steps on that same state until ``--seconds`` have passed and ends in a
synchronise. The rate is all clips stepped over all that time.

The check: the fp32 reference follows those first steps from the same
weights, batches and factors. Compared: the first step's loss (relative
gap), and the norm of each leaf's change after the first steps, taken
before the window's first step, by the worst leaf and by the 90th
percentile's; a norm's gap is measured against the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move under
Adam by round-off alone and are left out. The norm of each leaf's first
gradient as the optimizer got it (AdamW's first moment after one step,
exp_avg / (1 − β1)) is kept for ``calibrate.py``'s look, not compared.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from benchmark import counts, program, trace, traffic, weights
from benchmark.reference import arch as ref_arch
from benchmark.reference import lowp, models
from benchmark.reference import train as ref_train

B1 = 0.9  # AdamW's beta1, the program's and the reference's


def _inputs(run, a) -> tuple:
    keys, tr, dev = run.keys, run.cell["traffic"], run.device
    gen = traffic.generator(run.seed, "inputs", dev)
    lgen = traffic.generator(run.seed, "labels", dev)
    dgen = traffic.generator(run.seed, "drop")
    b = tr["batch"]
    pool, drops = [], []
    for _ in range(tr["pool"]):
        batch = traffic.clips(b, a.frames, a.crop, a.freq_bins, a.window, gen, torch.float32)
        batch["labels_hm"] = traffic.gaze_heatmaps(b, a.frames, a.crop // a.patch_stride[1],
                                                   keys["DATA.GAUSSIAN_KERNEL"], lgen)
        pool.append(batch)
        drops.append(traffic.drop_factors([blk.drop_path for blk in a.video], b, dgen, dev))
    return pool, drops


def setup(run) -> Dict:
    from csts_torch.models.csts import build_spec
    from csts_torch.train import step as train_lib

    keys, tr, dev = run.keys, run.cell["traffic"], run.device
    cfg = program.program_cfg(keys)
    spec = build_spec(cfg)
    a = ref_arch.csts_arch(keys)
    with dev:
        state = train_lib.create_train_state(
            cfg, spec, state_dict=weights.make(run.seed, models.csts_params(a), dev), device=dev)
    step = train_lib.make_train_step(cfg, spec, tr["steps_per_epoch"])
    run.mark("training state")
    pool, drops = _inputs(run, a)
    run.mark("inputs")
    named = dict(state.model.named_parameters())
    p0 = {n: p.detach().clone() for n, p in named.items()}
    losses, grad = [], None
    for j in range(tr["check_steps"]):
        stats, _ = step(state, pool[j], None, drop=drops[j])
        run.mark(f"step {j + 1}")
        losses.append(stats["loss"])
        if j == 0:
            opt = state.optimizer.opt
            grad = {n: float(torch.linalg.vector_norm(opt.state[p]["exp_avg"]) / (1 - B1))
                    for n, p in named.items()}
    change = {n: float(torch.linalg.vector_norm(p.detach() - p0[n])) for n, p in named.items()}
    del p0
    program.sync(dev)
    return {"state": state, "step": step, "pool": pool, "drops": drops,
            "program": {"loss": [float(x) for x in losses], "grad": grad, "change": change},
            "flops_per_clip": counts.csts_train_flops(a)}


def window(run, st) -> Dict:
    tr, dev = run.cell["traffic"], run.device
    state, step, pool, drops = st["state"], st["step"], st["pool"], st["drops"]
    setup_peak = program.peak_bytes(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    j, steps = tr["check_steps"], 0

    def one():
        nonlocal j, steps
        step(state, pool[j % len(pool)], None, drop=drops[j % len(pool)])
        j, steps = j + 1, steps + 1

    summary, traced_steps, traced_s = None, 0, 0.0
    program.sync(dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        if run.trace and summary is None and time.perf_counter() - t0 >= run.seconds / 2:
            summary, traced_steps, traced_s = trace.traced_calls(one, tr["trace_steps"])
            continue
        one()
    program.sync(dev)
    elapsed = time.perf_counter() - t0
    b = tr["batch"]
    window_peak = program.peak_bytes(dev)
    ctx = {"clips": steps * b, "steps": steps, "window_s": elapsed, "attempted": steps,
           "failed": 0, "memory_peak_bytes": max(setup_peak, window_peak),
           "window_peak_bytes": window_peak, "flops_per_clip": st["flops_per_clip"],
           "untraced_clips": (steps - traced_steps) * b, "untraced_s": elapsed - traced_s,
           "train": True}
    if summary is not None:
        ctx["trace"] = summary
        ctx["traced_steps"] = tr["trace_steps"]
    return ctx


def readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers of a run ``prog`` against the reference's
    ``ref``: the first step's loss gap, and of the moved leaves' change norm
    gaps the worst and the 90th percentile's. Neither the later steps'
    losses nor any first-gradient norm gap is compared: the program's
    readings of those lie within 3x of the fp8 control's (PERF.md)."""
    names = list(ref["grad"])
    med = sorted(ref["grad"].values())[len(names) // 2]
    moved = [n for n in names if ref["grad"][n] >= 1e-3 * med]
    return {"loss_gap": abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
            "change_norm_gap": program.norm_gap(prog["change"], ref["change"], moved),
            "change_norm_gap_p90": program.norm_gap(prog["change"], ref["change"], moved, 0.9)}


def check(run, st, ctx, controls=()) -> List[Dict]:
    """The readings of the program's first steps; ``controls``: also those
    of the reference run in fp8 in the program's place ("fp8") and of the
    reference with half of each batch left out ("half"), by reading name +
    "." + control; with "dump", each side's losses and per-leaf norms too
    (``dump.program``, ``dump.reference``, ``dump.<control>``)."""
    keys, tr, dev = run.keys, run.cell["traffic"], run.device
    n = tr["check_steps"]
    prog, batches, drops = st["program"], st["pool"][:n], st["drops"][:n]
    st.clear()
    program.free(dev)
    program.reference_mode()
    a = ref_arch.csts_arch(keys)
    p0 = weights.make(run.seed, models.csts_params(a), dev)
    spe = tr["steps_per_epoch"]
    ref = ref_train.train(p0, a, keys, batches, drops, spe)
    out = [{"name": k, "value": v} for k, v in readings(prog, ref).items()]
    if "dump" in controls:
        out += [{"name": "dump.program", "value": prog}, {"name": "dump.reference", "value": ref}]
    variants = {"fp8": dict(rd=lowp.fp8), "half": dict(rows=tr["batch"] // 2)}
    for c in controls:
        if c in variants:
            low = ref_train.train(p0, a, keys, batches, drops, spe, **variants[c])
            out += [{"name": f"{k}.{c}", "value": v} for k, v in readings(low, ref).items()]
            if "dump" in controls:
                out.append({"name": f"dump.{c}", "value": low})
    return out

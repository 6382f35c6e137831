"""The comparisons that decide ``correct`` fail when they should.

On the CPU, at the reduced family members in fp32 (where the program and
the reference agree to rounding): a run whose timed path is broken
underneath comes out not correct, once for each fault its cell can have
(an answer altered where it is produced; a kernel that drops a bias or
ignores a LayerNorm gain or shift; a training step that leaves its state
unchanged; half of the batch left out, the loss taken over the rest). On
the card (``cuda``), at the published widths: the control, the reference
in fp8 in the program's place, fails a limit that the program's own
readings pass, on three seeds.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import support

SEED = 2 ** 31 + 901


def _run(root, cell):
    return harness.run_cell(root, cell, SEED, 0.3, False, time.perf_counter(), "cpu")


def test_sound_runs_are_correct(tmp_path):
    root = support.checkout(tmp_path, fp32=True)
    for cell in support.SMALL:
        out = _run(root, cell)
        assert out["correct"], (cell, out["checks"])


def test_an_altered_heatmap_is_caught(tmp_path, monkeypatch):
    from csts_torch.train import step as train_lib

    real = train_lib.make_eval_step

    def broken(cfg, spec):
        step = real(cfg, spec)
        return lambda model, batch: torch.roll(step(model, batch), 1, dims=3)

    monkeypatch.setattr(train_lib, "make_eval_step", broken)
    assert not _run(support.checkout(tmp_path, fp32=True), "csts_small_eval")["correct"]


def test_altered_logits_are_caught(tmp_path, monkeypatch):
    from csts_torch.models import mvit_classifier

    real = mvit_classifier.MViT.forward
    monkeypatch.setattr(mvit_classifier.MViT, "forward",
                        lambda self, *a, **k: torch.roll(real(self, *a, **k), 1, dims=-1))
    assert not _run(support.checkout(tmp_path, fp32=True), "mvit_small_eval")["correct"]


def test_an_altered_served_answer_is_caught(tmp_path, monkeypatch):
    from csts_torch import serving

    real = serving.GazePredictor.predict

    def broken(self, video, audio):
        out = real(self, video, audio)
        out["heatmaps"] = out["heatmaps"][..., ::-1].copy()
        return out

    monkeypatch.setattr(serving.GazePredictor, "predict", broken)
    assert not _run(support.checkout(tmp_path, fp32=True), "csts_small_serve")["correct"]


# (cell, the kernel's entry in csts_torch.kernels.block, the position of the
# argument it mishandles, what it reads there instead)
MISAPPLIED = {
    "k2_drops_fc2_bias": ("mvit_small_eval", "fused_mlp_tail", 6, torch.zeros_like),
    "k2_ignores_ln2_gain": ("mvit_small_eval", "fused_mlp_tail", 1, torch.ones_like),
    "b3_ignores_ln2_gain": ("csts_small_eval", "fused_block", 10, torch.ones_like),
    "b3_ignores_ln2_shift": ("csts_small_eval", "fused_block", 11, torch.zeros_like),
    "b3_drops_fc2_bias": ("csts_small_eval", "fused_block", 15, torch.zeros_like),
    "b4_ignores_ln2_gain": ("csts_small_eval", "fused_pool_block", 11, torch.ones_like),
    "b5_ignores_ln2_gain": ("csts_small_eval", "fused_decoder_block", 12, torch.ones_like),
}


@pytest.mark.parametrize("fault", sorted(MISAPPLIED))
def test_a_misapplied_bias_or_gain_is_caught(tmp_path, monkeypatch, fault):
    from csts_torch.kernels import block as kb

    cell, entry, at, instead = MISAPPLIED[fault]
    real, calls = getattr(kb, entry), []

    def broken(*args, **kwargs):
        calls.append(entry)
        args = list(args)
        args[at] = instead(args[at])
        return real(*args, **kwargs)

    monkeypatch.setattr(kb, entry, broken)
    out = _run(support.checkout(tmp_path, fp32=True), cell)
    assert calls, f"{entry} is not on {cell}'s timed path"
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_training_step_is_caught(tmp_path, monkeypatch, fault):
    from csts_torch.train import step as train_lib

    real = train_lib.make_train_step

    def broken(cfg, spec, steps_per_epoch, accum_steps=1):
        step = real(cfg, spec, steps_per_epoch, accum_steps)

        def run(state, batch, gen, drop=None):
            if fault == "half_batch":
                n = batch["video"].shape[0] // 2
                batch = {k: v[:n] for k, v in batch.items()}
                drop = [None if d is None else tuple(m[:n] for m in d) for d in drop]
                return step(state, batch, gen, drop)
            saved = [p.detach().clone() for p in state.model.parameters()]
            out = step(state, batch, gen, drop)
            with torch.no_grad():
                for p, s in zip(state.model.parameters(), saved):
                    p.copy_(s)
            return out
        return run

    monkeypatch.setattr(train_lib, "make_train_step", broken)
    out = _run(support.checkout(tmp_path, fp32=True), "csts_small_train")
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,traffic", [
    ("csts_eval_b32", {"batch": 4, "check_clips": 4}),
    ("mvit_k400_eval_b32", {"batch": 4, "check_clips": 4}),
    ("csts_train_b16", {}),
])
def test_fp8_control_fails_where_the_program_passes(cell, traffic):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = support.load(f"{support.ROOT}/benchmark/workloads/{cell}.json")
    config = support.load(f"{support.ROOT}/benchmark/configs/{c['config']}.json")
    c["traffic"].update(traffic)
    for seed in (11, 2 ** 31 + 12, 2 ** 33 + 13):
        run = harness.Run(cell, c, config, seed, 2.0, False, torch.device("cuda"))
        driver = harness.load_module(f"{support.ROOT}/benchmark/drivers/{c['driver']}.py",
                                     "benchmark_driver_" + c["driver"])
        st = driver.setup(run)
        try:
            got = {r["name"]: r["value"] for r in driver.check(
                run, st, driver.window(run, st), controls=("fp8",))}
        finally:
            if hasattr(driver, "close"):
                driver.close(st)
        names = [n for n in c["limits"] if f"{n}.fp8" in got]
        assert names
        assert all(got[n] <= c["limits"][n] for n in c["limits"])
        assert any(got[f"{n}.fp8"] > c["limits"][n] for n in names), got

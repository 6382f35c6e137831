"""The frozen reference of ``benchmark/reference/`` against the port's plain
path on the CPU, in fp32, at the reduced family members (crop 32, depth 4,
width 16): the only place where the program meets the reference. The same
seeded weights and inputs go to both."""

from __future__ import annotations

import pytest
import torch

from benchmark import program, traffic, weights
from benchmark.reference import arch, models
from benchmark.drivers import train as train_driver
from benchmark.reference import train as ref_train
from benchmark.tests import support

SEED = 2 ** 31 + 77


def _keys(config: str, extra=None) -> dict:
    return support.small_config(config, extra or {}, fp32=True)["set"]


def _csts(keys):
    from csts_torch.models.csts import CSTS, build_spec

    a = arch.csts_arch(keys)
    cfg = program.program_cfg(keys)
    model = CSTS(build_spec(cfg))
    model.load_state_dict(weights.make(SEED, models.csts_params(a), "cpu"), strict=True)
    return a, cfg, model


def _inputs(a, batch):
    gen = traffic.generator(SEED, "inputs")
    return traffic.clips(batch, a.frames, a.crop, a.freq_bins, a.window, gen, torch.float32)


def test_csts_forward_matches_the_port():
    # fp32 on both sides: the products' order alone differs (1e-5 of the logits' scale)
    keys = _keys("csts_b_16x4")
    a, _, model = _csts(keys)
    x = _inputs(a, 2)
    P = weights.make(SEED, models.csts_params(a), "cpu")
    with torch.no_grad():
        got = model.eval()(x["video"], x["audio"])
        ref = models.csts_forward(P, a, x["video"], x["audio"])
    assert got.shape == ref.shape == (2, a.frames, a.crop // 4, a.crop // 4, 1)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_csts_training_forward_matches_the_port():
    # the training route with stochastic-depth factors, and EgoNCE's embeddings
    keys = _keys("csts_b_16x4")
    a, _, model = _csts(keys)
    x = _inputs(a, 4)
    drop = traffic.drop_factors([b.drop_path for b in a.video], 4, traffic.generator(SEED, "drop"),
                                "cpu")
    P = weights.make(SEED, models.csts_params(a), "cpu")
    with torch.no_grad():
        got = model.train()(x["video"], x["audio"], return_embed=True, drop=drop)
        ref = models.csts_forward(P, a, x["video"], x["audio"], drop, embed=True)
    for g, r in zip(got, ref):
        assert (g - r).abs().max() <= 1e-5 * r.abs().max()


def test_mvit_forward_matches_the_port():
    from csts_torch.models.mvit_classifier import MViT, build_mvit_spec

    keys = _keys("mvit_b_16x4_k400", {"DATA.NUM_FRAMES": 8, "MODEL.NUM_CLASSES": 11})
    a = arch.mvit_arch(keys)
    model = MViT(build_mvit_spec(program.program_cfg(keys)))
    P = weights.make(SEED, models.mvit_params(a), "cpu")
    model.load_state_dict(P, strict=True)
    video = traffic.clips(2, a.frames, a.crop, 0, 0, traffic.generator(SEED, "inputs"),
                          torch.float32, audio=False)["video"]
    with torch.no_grad():
        got = model.eval()(video)
        ref = models.mvit_forward(P, a, video)
    assert got.shape == ref.shape == (2, 11)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("steps", [1, 3])
def test_training_steps_match_the_port(steps):
    # the loss, the clipped first gradient as AdamW's first moment holds it
    # and the weights' change, against the port's fp32 make_train_step
    from csts_torch.models.csts import build_spec
    from csts_torch.train import step as train_lib

    keys = _keys("csts_b_16x4")
    a = arch.csts_arch(keys)
    cfg = program.program_cfg(keys)
    spec = build_spec(cfg)
    p0 = weights.make(SEED, models.csts_params(a), "cpu")
    state = train_lib.create_train_state(cfg, spec, state_dict=p0, device="cpu")
    step = train_lib.make_train_step(cfg, spec, 1000)
    gen, lgen, dgen = (traffic.generator(SEED, s) for s in ("inputs", "labels", "drop"))
    batches, drops = [], []
    for _ in range(steps):
        b = traffic.clips(4, a.frames, a.crop, a.freq_bins, a.window, gen, torch.float32)
        b["labels_hm"] = traffic.gaze_heatmaps(4, a.frames, a.crop // 4, 19, lgen)
        batches.append(b)
        drops.append(traffic.drop_factors([x.drop_path for x in a.video], 4, dgen, "cpu"))
    losses, grad = [], None
    named = dict(state.model.named_parameters())
    for j in range(steps):
        stats, _ = step(state, batches[j], None, drop=drops[j])
        losses.append(float(stats["loss"]))
        if j == 0:
            grad = {n: float(torch.linalg.vector_norm(state.optimizer.opt.state[p]["exp_avg"]))
                    / 0.1 for n, p in named.items()}
    change = {n: float(torch.linalg.vector_norm(p.detach() - p0[n])) for n, p in named.items()}
    ref = ref_train.train(p0, a, keys, batches, drops, 1000)
    got = train_driver.readings({"loss": losses, "grad": grad, "change": change}, ref)
    assert max(abs(x - y) / abs(y) for x, y in zip(losses, ref["loss"])) <= 1e-5
    assert got["loss_gap"] <= 1e-5
    assert program.norm_gap(grad, ref["grad"], list(ref["grad"])) <= 1e-4
    assert got["change_norm_gap"] <= 1e-3 and got["change_norm_gap_p90"] <= 1e-3


def test_fp8_control_rounds_to_three_mantissa_bits():
    from benchmark.reference import lowp

    x = torch.linspace(-3.0, 5.0, 1001)
    y = lowp.round_fp8(x)
    assert y.abs().max() == x.abs().max()  # the largest maps to fp8's largest and back
    rel = ((y - x).abs() / x.abs().clamp(min=1e-3))[x.abs() > 0.1]
    assert 0.02 < rel.max() <= 2 ** -4 + 1e-6  # half a step of 3 mantissa bits

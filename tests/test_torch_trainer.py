"""The port's training entry point against the JAX package's, on the CPU.

* GradCache (``accum_steps=2``) against one pass over the same batch, and
  against ``make_train_step(accum_steps=2)`` with JAX's masks injected; the
  micro-batch mean without EgoNCE.
* MODEL.ACT_CHECKPOINT on against off: the blocks run again in the
  backward, the gradients agree within 1e-6 relative.
* SOLVER.BF16_MOMENTS against optax's ``mu_dtype=bfloat16`` over two updates.
* The train and val meters' JSON records against the JAX package's.
* ``train()`` against ``csts_tpu.train.trainer.train`` on one synthetic
  split from one JAX-written init npz (CHECKPOINT_EPOCH_RESET), 2 epochs of
  2 iterations, DROPPATH_RATE 0: each iteration's loss and F1, the val F1
  and the final npz leaf by leaf, at the bars stated in the test.
* A preempted and resumed run (the injection hook, and a real SIGTERM) is
  bit-equal to an uninterrupted one.
* ``run_net`` trains, then tests, from a YAML on ``--device cpu``.
"""

from __future__ import annotations

import json
import os
import signal

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from csts_tpu.train import meters as jmeters
from csts_tpu.train import step as jstep
from csts_tpu.train import trainer as jtrainer
from csts_tpu.models import csts as jcsts
from csts_tpu.train.optimizer import construct_optimizer as jax_optimizer
from csts_tpu.utils import checkpoint as jcu
from csts_torch import ops, presets
from csts_torch.convert.from_jax import state_dict_from_jax
from csts_torch.data.synthetic import write_dataset
from csts_torch.eval.tester import test as port_test
from csts_torch.models.csts import build_spec
from csts_torch.models import mvit
from csts_torch.tools import run_net
from csts_torch.train import meters as tmeters
from csts_torch.train import step as tstep
from csts_torch.train import trainer as ttrainer
from csts_torch.train.optimizer import construct_optimizer
from csts_torch.utils import checkpoint as tcu
from csts_torch.utils import orbax_ckpt
from test_torch_train import _jax_drop_masks

torch.set_num_threads(2)

BATCH = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _heatmaps(rng, shape):
    hm = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    return hm / hm.sum(axis=(-2, -1), keepdims=True)


@pytest.fixture(scope="module")
def small():
    """One JAX init and one batch of 4 shared by the step tests."""
    jcfg = graft._small_cfg(BATCH)
    jcfg.MVIT.DROPPATH_RATE = 0.2
    jspec = jcsts.build_spec(jcfg)
    params = jcsts.csts_init(jax.random.PRNGKey(0), jspec)
    rng = np.random.default_rng(6)
    batch = {
        "video": rng.standard_normal((BATCH, 8, 32, 32, 3)).astype(np.float32),
        "audio": rng.standard_normal((BATCH, 8, 32, 32, 1)).astype(np.float32),
        "labels_hm": _heatmaps(rng, (BATCH, 8, 8, 8)),
    }
    return jspec, params, batch


def _tcfg(**model):
    cfg = presets.small_cfg(BATCH)
    cfg.MVIT.DROPPATH_RATE = 0.2
    for k, v in model.items():
        setattr(cfg.MODEL, k, v)
    return cfg


def _state(cfg, params):
    """The port's state from JAX's init; the NCE heads only where the loss has them."""
    sd = state_dict_from_jax(_np(params))
    if "nce" not in cfg.MODEL.LOSS_FUNC:
        sd = {k: v for k, v in sd.items() if not k.startswith(("vision_proj", "audio_proj"))}
    return tstep.create_train_state(cfg, build_spec(cfg), state_dict=sd, device="cpu")


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _grads_of_step(cfg, params, batch, drop, accum):
    """One step's stats and the gradients it applied (read before the update)."""
    state = _state(cfg, params)
    seen = {}
    update = state.optimizer.step

    def record(lr):
        seen.update({n: p.grad.detach().clone() for n, p in state.model.named_parameters()})
        return update(lr)

    state.optimizer.step = record
    stats, preds = tstep.make_train_step(cfg, build_spec(cfg), 10, accum_steps=accum)(
        state, _tbatch(batch), None, drop=drop)
    return stats, preds, seen, state


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / max(float(torch.linalg.vector_norm(b)), 1e-30))


def _micro_masks(spec, seed, accum):
    gen = torch.Generator().manual_seed(seed)
    micro = [ops.sample_drop_masks(spec.video_blocks, BATCH // accum, gen) for _ in range(accum)]
    whole = [None if m[0] is None else tuple(torch.cat([x[j] for x in m]) for j in range(2))
             for m in zip(*micro)]
    return micro, whole


@pytest.mark.parametrize("loss", ["kldiv+egonce", "kldiv"])
def test_accumulation_matches_one_pass(small, loss):
    """accum_steps=2 against accum_steps=1 on the same batch and masks: the
    stats within 1e-6 relative, each gradient within 1e-5 relative norm plus
    1e-6 of the whole gradient's norm (the same sums in another order; the
    pooled keys' norm biases have an exact gradient of 0). EgoNCE runs the
    GradCache two-pass, kldiv alone the micro-batch mean."""
    _, params, batch = small
    cfg = _tcfg(LOSS_FUNC=loss)
    micro, whole = _micro_masks(build_spec(cfg), 3, 2)
    s1, p1, g1, _ = _grads_of_step(cfg, params, batch, whole, 1)
    s2, p2, g2, _ = _grads_of_step(cfg, params, batch, micro, 2)
    for k in s1:
        assert float(s2[k]) == pytest.approx(float(s1[k]), rel=1e-6), k
    torch.testing.assert_close(p2, p1, rtol=0, atol=1e-6)
    total = float(np.sqrt(sum(float(torch.linalg.vector_norm(g)) ** 2 for g in g1.values())))
    for n in g1:
        err = float(torch.linalg.vector_norm(g2[n] - g1[n]))
        assert err <= 1e-5 * float(torch.linalg.vector_norm(g1[n])) + 1e-6 * total, n


def test_grad_cache_matches_jax_accumulation(small):
    """``make_train_step(accum_steps=2)`` of both packages from one init, one
    batch and JAX's per-micro-batch masks (split(rng, 2), rebuilt and
    injected): the losses within 1e-5 relative and each weight within
    2·BASE_LR (test_torch_train.py's step bar); the pre-clip gradient norm
    within 1e-3 relative. At this batch and these masks the objective is
    ill-conditioned in the first two video blocks: changing the weights by
    1e-7 relative moves their gradients by ~2% in either package alone, so
    the two packages' fp32 sums put the global norm ~8e-5 apart (PERF.md
    §7); Adam's normalised step keeps the weights within the step bar."""
    jspec, params, batch = small
    jcfg = graft._small_cfg(BATCH)
    jcfg.MVIT.DROPPATH_RATE = 0.2
    state, tx = jstep.create_train_state(jcfg, jspec, jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(31)
    state, jstats, _ = jstep.make_train_step(jcfg, jspec, tx, 10, accum_steps=2)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    masks = [_jax_drop_masks(jspec, k, BATCH // 2) for k in jax.random.split(key, 2)]
    cfg = _tcfg()
    stats, _, _, tstate = _grads_of_step(cfg, params, batch, masks, 2)
    for name in ("loss", "kldiv_loss", "egonce_loss", "lr"):
        assert float(stats[name]) == pytest.approx(float(jstats[name]), rel=1e-5), name
    assert float(stats["grad_norm"]) == pytest.approx(float(jstats["grad_norm"]), rel=1e-3)
    want = state_dict_from_jax(_np(state.params))
    for n, p in tstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=2 * cfg.SOLVER.BASE_LR, rtol=0, err_msg=n)


def test_act_checkpoint_recomputes_and_matches(small):
    """MODEL.ACT_CHECKPOINT: every encoder block (16 video and audio forwards
    here: 4 + 4 blocks) runs once more in the backward, and the loss and
    every gradient equal the plain step's within 1e-6 relative."""
    _, params, batch = small
    cfg_off, cfg_on = _tcfg(), _tcfg(ACT_CHECKPOINT=True)
    assert build_spec(cfg_on).remat
    _, whole = _micro_masks(build_spec(cfg_off), 4, 1)
    calls = {"n": 0}
    forward = mvit.MultiScaleBlock.forward_train

    def counted(self, *a, **k):
        calls["n"] += 1
        return forward(self, *a, **k)

    out = {}
    for tag, cfg in (("off", cfg_off), ("on", cfg_on)):
        calls["n"] = 0
        mvit.MultiScaleBlock.forward_train = counted
        try:
            out[tag] = _grads_of_step(cfg, params, batch, whole, 1)
        finally:
            mvit.MultiScaleBlock.forward_train = forward
        out[tag] += (calls["n"],)
    n_enc = 4 + len(build_spec(cfg_on).audio_blocks)
    assert out["on"][4] == out["off"][4] + n_enc
    assert float(out["on"][0]["loss"]) == pytest.approx(float(out["off"][0]["loss"]), rel=1e-6)
    for n, g in out["off"][2].items():
        assert _rel(out["on"][2][n], g) <= 1e-6, n


def test_bf16_moments_match_optax(small):
    """Two updates with SOLVER.BF16_MOMENTS from one init and the same
    gradients against optax (mu_dtype bfloat16): nu within 1e-6 relative,
    mu within two bf16 ulps of the leaf's largest moment of optax's (one
    rounding apart after each update: the fp32 sums before the rounding
    differ in their last bits, and where b1·mu and (1 - b1)·g cancel the
    error keeps the terms' size) and stored as bf16;
    the weights within 1e-6 (test_torch_train.py's update bar) plus the
    second update's lr times two bf16 ulps, 2e-4·2**-7: the two packages'
    fp32 first moments can round to neighbouring bf16 values after the
    first update, which moves the second by that share of its size (≤ lr).
    The gradients' norm is above the clip."""
    _, params, _ = small
    jcfg = graft._small_cfg(BATCH)
    cfg = _tcfg()
    for c in (jcfg, cfg):
        c.SOLVER.BF16_MOMENTS = True
    tx = jax_optimizer(params, jcfg)
    opt_state = tx.init(params)
    state = _state(cfg, params)
    opt = construct_optimizer(state.model, cfg)
    jparams = params
    rng = np.random.default_rng(2)
    for lr in (3e-4, 2e-4):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), jparams)
        opt_state.hyperparams["learning_rate"] = jnp.float32(lr)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        g_sd = state_dict_from_jax(_np(grads))
        for n, p in state.model.named_parameters():
            p.grad = g_sd[n].clone()
        opt.step(lr)
    want = state_dict_from_jax(_np(jparams))
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=1e-6 + 2e-4 * 2 ** -7, rtol=0, err_msg=n)
    adam = opt_state.inner_state[1]
    mu_want = state_dict_from_jax(_np(jax.tree_util.tree_map(lambda m: m.astype(jnp.float32),
                                                             adam.mu)))
    nu_want = state_dict_from_jax(_np(adam.nu))
    count, mu, nu = opt.moments()
    assert count == 2 == int(adam.count)
    for n in mu:
        assert mu[n].dtype == torch.bfloat16
        got, ref = mu[n].float().numpy(), mu_want[n].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=2 * 2 ** -8 * np.abs(ref).max(),
                                   err_msg=n)
        np.testing.assert_allclose(nu[n].numpy(), nu_want[n].numpy(), rtol=1e-6, atol=1e-12,
                                   err_msg=n)


# ----------------------------------------------------------------------------------
# meters
# ----------------------------------------------------------------------------------

TIMING = {"dt", "dt_data", "dt_net", "eta", "device_mem", "RAM"}


def _records(caplog_text):
    return [json.loads(line.split("json_stats: ", 1)[1]) for line in caplog_text.splitlines()
            if "json_stats: " in line]


def test_meters_log_what_jax_logs(monkeypatch):
    """The same stats through both packages' train and val meters give the
    same records: the same keys, and equal values except the timers and
    the memory fields."""
    cfg = presets.small_cfg(2)
    cfg.LOG_PERIOD, cfg.SOLVER.MAX_EPOCH = 2, 3
    logged = {"jax": [], "port": []}
    monkeypatch.setattr(jmeters, "log_json_stats", lambda s: logged["jax"].append(dict(s)))
    monkeypatch.setattr(tmeters, "log_json_stats", lambda s: logged["port"].append(dict(s)))
    rng = np.random.default_rng(0)
    train_stats = [tuple(float(x) for x in rng.uniform(0, 1, 5)) for _ in range(5)]
    val_stats = [(tuple(float(x) for x in rng.uniform(0, 1, 4)), int(rng.integers(0, 9)))
                 for _ in range(3)]
    labels = rng.integers(0, 3, (2, 8, 3)).astype(np.float32)
    for pkg, mod in (("jax", jmeters), ("port", tmeters)):
        tm, vm = mod.TrainGazeMeter(5, cfg), mod.ValGazeMeter(3, cfg)
        for epoch in (0, 1):
            tm.iter_tic()
            for i, (f1, r, p, th, loss) in enumerate(train_stats):
                tm.data_toc()
                tm.update_stats(f1, r, p, th, loss, 1e-4 * (i + 1), mb_size=2)
                tm.iter_toc()
                tm.log_iter_stats(epoch, i)
                tm.iter_tic()
            tm.log_epoch_stats(epoch)
            tm.reset()
            for i, ((f1, r, p, th), w) in enumerate(val_stats):
                vm.update_stats(f1, r, p, None, th, 0, weight=w)
                vm.log_iter_stats(epoch, i)
            vm.update_stats(0.5, 0.25, 0.75, labels, 0.1, 0)  # the weight from the labels
            vm.log_epoch_stats(epoch)
            vm.reset()
        timer = mod.EpochTimer()
        timer.epoch_tic()
        timer.epoch_toc()
        assert timer.last_epoch_time() >= 0 and timer.avg_epoch_time() >= 0
    jax_records, port_records = logged["jax"], logged["port"]
    assert [r["_type"] for r in port_records] == [r["_type"] for r in jax_records]
    assert {r["_type"] for r in port_records} == {"train_iter", "train_epoch", "val_iter",
                                                  "val_epoch"}
    for got, want in zip(port_records, jax_records):
        assert set(got) == set(want)
        assert {k: v for k, v in got.items() if k not in TIMING} == \
            {k: v for k, v in want.items() if k not in TIMING}


# ----------------------------------------------------------------------------------
# the trainer
# ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Four clips of 32x48: with the jitter scales at the crop's 32 the
    train transform crops and flips without resizing, so both packages'
    loaders give the same batches (their uint8 resizes differ by a level)."""
    root = str(tmp_path_factory.mktemp("train"))
    return write_dataset(root, "ego4d", num_clips=4, res=(32, 48), seed=3)


def _train_cfgs(split, out, drop=0.0, ema=0.0):
    prefix, splits = split
    pair = graft._small_cfg(2), presets.small_cfg(2)
    for c in pair:
        c.DATA.PATH_PREFIX, c.DATA.PATH_TO_DATA_DIR = prefix, splits
        c.DATA.DECODING_BACKEND = "npy"
        c.DATA.GAUSSIAN_KERNEL = 5
        c.DATA.TRAIN_JITTER_SCALES = [32, 32]
        c.MVIT.DROPPATH_RATE = drop
        c.SOLVER.EMA_DECAY = ema
        c.SOLVER.MAX_EPOCH = 2
        c.TRAIN.EVAL_PERIOD = c.TRAIN.CHECKPOINT_PERIOD = 1
        c.TRAIN.CHECKPOINT_EPOCH_RESET = True
        c.DATA_LOADER.NUM_WORKERS = 0
        c.LOG_PERIOD = 1
        c.TEST.ENABLE = False
    pair[0].OUTPUT_DIR, pair[1].OUTPUT_DIR = str(out / "jax"), str(out / "port")
    return pair


def _json_log(out_dir, kind):
    with open(os.path.join(out_dir, "stdout.log")) as f:
        return [r for r in _records(f.read()) if r["_type"] == kind]


def test_trainer_tracks_jax(split, tmp_path, monkeypatch):
    """Both ``train()``s from one JAX-written init npz over 2 epochs of 2
    iterations (batch 2, lr 1e-4 cosine, DROPPATH_RATE 0).

    Bars, from four AdamW steps at lr ≤ 1e-4: each iteration's loss within
    1e-5 relative (test_torch_train.py's first-step bar: the weights differ
    by less than 2·Σlr = 5e-4 when a step runs) and its lr within 1e-6; the
    batch F1 within 5e-3 and the val F1, recall and precision within 5e-3
    (the F1 is taken at the best of 10 thresholds over 512 pixels a frame:
    a weight difference of ~1e-5 moves a pixel across a threshold, 1/512 of
    a frame's count); the final weights within 2·Σlr, the EMA-free first
    and second moments within 2e-3 of their largest magnitude (the step
    bar's gradient tolerance of test_torch_train.py), counts and step equal,
    the lr leaf within 1e-6 relative."""
    jcfg, tcfg = _train_cfgs(split, tmp_path)
    jspec = jcsts.build_spec(jcfg)
    state, _ = jstep.create_train_state(jcfg, jspec, jax.random.PRNGKey(0))
    init = jcu.save_checkpoint(str(tmp_path / "init"), _np(state), 0, jcfg)
    for c in (jcfg, tcfg):
        c.TRAIN.CHECKPOINT_FILE_PATH = init
    seen = {"jax": [], "port": []}
    for tag, mod in (("jax", jmeters), ("port", tmeters)):
        update = mod.TrainGazeMeter.update_stats

        def record(self, f1, r, p, th, loss, lr, mb_size, _tag=tag, _update=update):
            seen[_tag].append((loss, f1, lr))
            return _update(self, f1, r, p, th, loss, lr, mb_size)

        monkeypatch.setattr(mod.TrainGazeMeter, "update_stats", record)
    jtrainer.train(jcfg)
    ttrainer.train(tcfg, device="cpu")
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for (tl, tf, tlr), (jl, jf, jlr) in zip(seen["port"], seen["jax"]):
        assert tl == pytest.approx(jl, rel=1e-5)
        assert tlr == pytest.approx(jlr, rel=1e-6)
        assert abs(tf - jf) <= 5e-3
    jval, tval = _json_log(jcfg.OUTPUT_DIR, "val_epoch"), _json_log(tcfg.OUTPUT_DIR, "val_epoch")
    assert len(tval) == len(jval) == 2
    for got, want in zip(tval, jval):
        for k in ("f1", "recall", "precision"):
            assert abs(got[k] - want[k]) <= 5e-3, (k, got[k], want[k])
    name = "checkpoints/checkpoint_epoch_00002.npz"
    ja, ta = np.load(os.path.join(jcfg.OUTPUT_DIR, name)), np.load(os.path.join(tcfg.OUTPUT_DIR,
                                                                                 name))
    assert sorted(ja.files) == sorted(ta.files)
    p = len(jcu.param_leaf_names(jcfg))
    lrs = sum(x[2] for x in seen["jax"])
    for i in range(len(ja.files)):
        got, want = ta[f"leaf_{i:05d}"], ja[f"leaf_{i:05d}"]
        assert got.shape == want.shape, i
        if i < p:
            np.testing.assert_allclose(got, want, atol=2 * lrs, rtol=0, err_msg=str(i))
        elif i in (p, p + 2, 3 * p + 3):
            assert int(got) == int(want) == 4, i
        elif i == p + 1:
            assert float(got) == pytest.approx(float(want), rel=1e-6)
        else:
            group = slice(p + 3, 2 * p + 3) if i < 2 * p + 3 else slice(2 * p + 3, 3 * p + 3)
            scale = max(float(np.abs(ja[f"leaf_{j:05d}"]).max())
                        for j in range(group.start, group.stop))
            np.testing.assert_allclose(got, want, atol=2e-3 * scale, rtol=0, err_msg=str(i))


def test_orbax_preemption_tracks_jax(split, tmp_path, monkeypatch):
    """Both ``train()``s with TRAIN.CHECKPOINT_BACKEND "orbax" from one
    JAX-written init npz, stopped after the first iteration and resumed:
    both commit the same global steps (1 at the stop, 2 and 4 at the epoch
    boundaries), and the params of the latest step, restored by each
    package's own backend, agree within ``test_trainer_tracks_jax``'s bar
    (2·Σlr), the step and Adam's count equal."""
    from csts_tpu.utils import orbax_ckpt as jorbax

    jcfg, tcfg = _train_cfgs(split, tmp_path)
    jspec = jcsts.build_spec(jcfg)
    state, _ = jstep.create_train_state(jcfg, jspec, jax.random.PRNGKey(0))
    init = jcu.save_checkpoint(str(tmp_path / "init"), _np(state), 0, jcfg)
    for c in (jcfg, tcfg):
        c.TRAIN.CHECKPOINT_FILE_PATH = init
        c.TRAIN.CHECKPOINT_BACKEND = "orbax"
    lrs = []
    update = tmeters.TrainGazeMeter.update_stats

    def record(self, f1, r, p, th, loss, lr, mb_size):
        lrs.append(lr)
        return update(self, f1, r, p, th, loss, lr, mb_size)

    monkeypatch.setattr(tmeters.TrainGazeMeter, "update_stats", record)
    for mod, run in ((jtrainer, lambda: jtrainer.train(jcfg)),
                     (ttrainer, lambda: ttrainer.train(tcfg, device="cpu"))):
        monkeypatch.setattr(mod, "_PREEMPT_AFTER_ITERS", 1)
        run()
        monkeypatch.setattr(mod, "_PREEMPT_AFTER_ITERS", None)
        run()
    jdir = os.path.join(jcfg.OUTPUT_DIR, "checkpoints_orbax")
    assert sorted(int(n) for n in os.listdir(jdir) if n.isdigit()) == [1, 2, 4]
    assert orbax_ckpt.committed_steps(tcfg.OUTPUT_DIR) == [1, 2, 4]
    assert len(lrs) == 4
    template, _ = jstep.create_train_state(jcfg, jspec, jax.random.PRNGKey(1))
    ck = jorbax.OrbaxCheckpointer(jcfg.OUTPUT_DIR)
    jstate, jstep_ = ck.restore(template)
    ck.close()
    port = tstep.create_train_state(tcfg, build_spec(tcfg), device="cpu")
    assert orbax_ckpt.OrbaxCheckpointer(tcfg.OUTPUT_DIR).restore(port)[1] == jstep_ == 4
    want = _np(jax.tree_util.tree_leaves(jstate.params))
    got = tcu.state_leaves(port)
    p = len(want)
    assert int(got[p]) == int(jstate.step) == 4 and int(got[p + 2]) == 4
    for i, w in enumerate(want):
        np.testing.assert_allclose(got[i], w, atol=2 * sum(lrs), rtol=0, err_msg=str(i))


def _final(out_dir):
    path = tcu.get_last_checkpoint(out_dir)
    assert path.endswith("checkpoint_epoch_00002.npz")
    return np.load(path)


@pytest.mark.parametrize("how", ["injected", "sigterm", "orbax"])
def test_preempted_run_resumes_bit_equal(split, tmp_path, monkeypatch, how):
    """Drop-path 0.2 and EMA on: a run stopped after the first iteration of
    the first epoch (by ``_PREEMPT_AFTER_ITERS``, or by a SIGTERM the process sends
    itself mid-step) saves an iter-tagged npz, and a second ``train()``
    resumes it there; the final npz equals an uninterrupted run's bit for
    bit, leaf by leaf. Under TRAIN.CHECKPOINT_BACKEND "orbax" (injected)
    the stop saves global step 1, the resumed run restores it and saves
    steps 2 and 4, and its final state equals the uninterrupted run's npz
    bit for bit."""
    _, whole = _train_cfgs(split, tmp_path / "whole", drop=0.2, ema=0.9)
    _, cut = _train_cfgs(split, tmp_path / "cut", drop=0.2, ema=0.9)
    ttrainer.train(whole, device="cpu")
    if how == "orbax":
        cut.TRAIN.CHECKPOINT_BACKEND = "orbax"
        monkeypatch.setattr(ttrainer, "_PREEMPT_AFTER_ITERS", 1)
        assert ttrainer.train(cut, device="cpu").step == 1
        assert orbax_ckpt.committed_steps(cut.OUTPUT_DIR) == [1]
        monkeypatch.setattr(ttrainer, "_PREEMPT_AFTER_ITERS", None)
        final = tcu.state_leaves(ttrainer.train(cut, device="cpu"))
        assert orbax_ckpt.committed_steps(cut.OUTPUT_DIR) == [1, 2, 4]
        assert not os.path.exists(tcu.checkpoint_dir(cut.OUTPUT_DIR))
        a = _final(whole.OUTPUT_DIR)
        assert len(final) == len(a.files)
        for i, got in enumerate(final):
            np.testing.assert_array_equal(got, a[f"leaf_{i:05d}"], err_msg=str(i))
        return
    if how == "injected":
        monkeypatch.setattr(ttrainer, "_PREEMPT_AFTER_ITERS", 1)
        ttrainer.train(cut, device="cpu")
    else:
        step = tstep.make_train_step

        def make(*a, **k):
            fn = step(*a, **k)

            def run(state, batch, gen, drop=None):
                out = fn(state, batch, gen, drop)
                if state.step == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                return out
            return run

        previous = signal.getsignal(signal.SIGTERM)
        monkeypatch.setattr(tstep, "make_train_step", make)
        try:
            ttrainer.train(cut, device="cpu")
        finally:
            signal.signal(signal.SIGTERM, previous)
        monkeypatch.setattr(tstep, "make_train_step", step)
    saved = tcu.get_last_checkpoint(cut.OUTPUT_DIR)
    assert saved.endswith("checkpoint_epoch_00000_iter_0000001.npz")
    assert tcu.checkpoint_meta(saved)["iter"] == 1
    monkeypatch.setattr(ttrainer, "_PREEMPT_AFTER_ITERS", None)
    ttrainer.train(cut, device="cpu")
    a, b = _final(whole.OUTPUT_DIR), _final(cut.OUTPUT_DIR)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_trainer_refuses_what_is_not_ported(split, tmp_path, monkeypatch):
    _, cfg = _train_cfgs(split, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrainer.train(cfg)
    # the orbax backend is ported (tests/test_torch_orbax_ckpt.py); a backend
    # that is neither raises before anything is built
    cfg.TRAIN.CHECKPOINT_BACKEND = "orbax"
    ttrainer._check_options(cfg)
    cfg.TRAIN.CHECKPOINT_BACKEND = "tensorstore"
    with pytest.raises(ValueError, match="npz or orbax"):
        ttrainer.train(cfg, device="cpu")
    cfg.TRAIN.CHECKPOINT_BACKEND = "npz"
    # TENSORBOARD.ENABLE is ported (tests/test_torch_tensorboard.py)
    cfg.TENSORBOARD.ENABLE = True
    ttrainer._check_options(cfg)


def test_run_net_trains_then_tests(split, tmp_path):
    """``run_net`` with a YAML, TRAIN.ENABLE and TEST.ENABLE on the CPU (two
    loader workers, GRAD_ACCUM_STEPS 2, ACT_CHECKPOINT, the profile of one
    iteration): it trains 2 epochs, writes an epoch npz each, and the test
    scores the newest exactly as ``tester.test`` scores that file."""
    prefix, splits = split
    yaml_path = tmp_path / "cfg.yaml"
    yaml_path.write_text(
        "TRAIN:\n  BATCH_SIZE: 2\n  EVAL_PERIOD: 2\n  CHECKPOINT_PERIOD: 1\n"
        "  GRAD_ACCUM_STEPS: 2\n  PROFILE_START_ITER: 1\n  PROFILE_NUM_ITERS: 1\n"
        f"DATA:\n  PATH_PREFIX: '{prefix}'\n  PATH_TO_DATA_DIR: '{splits}'\n"
        "  DECODING_BACKEND: npy\n  GAUSSIAN_KERNEL: 5   # small heatmaps\n"
        "  TRAIN_CROP_SIZE: 32\n  TEST_CROP_SIZE: 32\n  TRAIN_JITTER_SCALES: [32, 40]\n"
        "  AUDIO_FREQ_BINS: 32\n  AUDIO_WINDOW: 32\n"
        "MVIT:\n  DEPTH: 4\n  EMBED_DIM: 16\n  DROPPATH_RATE: 0.1\n  CLS_EMBED_ON: False\n"
        "  SEP_POS_EMBED: True\n  PATCH_PADDING: [1, 3, 3]\n  POOL_KVQ_KERNEL: [3, 3, 3]\n"
        "  POOL_KV_STRIDE_ADAPTIVE: [1, 8, 8]\n"
        "  DIM_MUL: [[1, 2.0], [2, 2.0], [3, 2.0]]\n  HEAD_MUL: [[1, 2.0], [2, 2.0], [3, 2.0]]\n"
        "  POOL_Q_STRIDE: [[1, 1, 2, 2], [2, 1, 2, 2], [3, 1, 2, 2]]\n"
        "SOLVER:\n  MAX_EPOCH: 2\n  COSINE_END_LR: 1e-6\n"
        "MODEL:\n  ACT_CHECKPOINT: True\n  LOSS_FUNC: kldiv+egonce\n"
        "TEST:\n  BATCH_SIZE: 4\n  NUM_ENSEMBLE_VIEWS: 1\n  NUM_SPATIAL_CROPS: 1\n"
        "DATA_LOADER:\n  NUM_WORKERS: 2\n")
    out = str(tmp_path / "run")
    got = run_net.main(["--device", "cpu", "--cfg", str(yaml_path), "OUTPUT_DIR", out])
    names = sorted(n for n in os.listdir(tcu.checkpoint_dir(out)) if n.endswith(".npz"))
    assert names == ["checkpoint_epoch_00001.npz", "checkpoint_epoch_00002.npz"]
    assert os.listdir(os.path.join(out, "profile"))
    assert len(_json_log(out, "train_epoch")) == 2 and len(_json_log(out, "val_epoch")) == 1
    from csts_torch.config import load_config

    cfg = load_config(str(yaml_path), ["OUTPUT_DIR", str(tmp_path / "direct"),
                                       "TEST.CHECKPOINT_FILE_PATH",
                                       os.path.join(tcu.checkpoint_dir(out), names[-1])])
    want = port_test(cfg, device="cpu")
    for k in ("f1", "recall", "precision", "auc", "threshold"):
        assert got[k] == want[k], k

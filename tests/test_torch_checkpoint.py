"""Checkpoints of the port against the JAX package (``csts_tpu.utils.checkpoint``).

* ``convert/to_jax.py`` inverts ``convert/from_jax.py`` bit for bit, and the
  port's ``param_leaf_names`` is the JAX package's.
* npz TrainState files pass both ways, EMA off and on, SOLVER.BF16_MOMENTS
  off and on: a JAX file loads into the port with params, moments, counts,
  lr, step and EMA exactly equal after the layout transposes; a port file
  passes ``csts_tpu.utils.checkpoint.load_checkpoint``'s leaf-count and
  shape asserts and gives back the same leaves; one further step on each
  side then agrees within the step bar of ``tests/test_torch_train.py``
  (stats 1e-4 relative, each weight within 2·BASE_LR).
* ``.pyth`` fine-tune init (position embeddings interpolated, shape-mismatched
  leaves kept, the audio branch remapped) gives the JAX path's tree within
  1e-7.
* The test chain scores a JAX npz (TEST.USE_EMA on and off) as
  ``csts_tpu.eval.tester.test`` does, at the tester's bars (threshold equal;
  f1, recall, precision, AUC within 1e-6).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from csts_tpu.convert import from_torch as jfrom_torch
from csts_tpu.convert.to_torch import export_csts_state_dict
from csts_tpu.eval.tester import test as jax_test
from csts_tpu.models import csts as jcsts
from csts_tpu.train import step as jstep
from csts_tpu.utils import checkpoint as jcu
from csts_torch import presets
from csts_torch.convert import from_torch, to_jax
from csts_torch.convert.from_jax import state_dict_from_jax
from csts_torch.data.synthetic import write_dataset
from csts_torch.eval.tester import test as port_test
from csts_torch.models.csts import CSTS, build_spec
from csts_torch.train import step as tstep
from csts_torch.utils import checkpoint as tcu

torch.set_num_threads(2)

BATCH = 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(**solver):
    jcfg, tcfg = graft._small_cfg(BATCH), presets.small_cfg(BATCH)
    for c in (jcfg, tcfg):
        c.MVIT.DROPPATH_RATE = 0.0
        for k, v in solver.items():
            setattr(c.SOLVER, k, v)
    return jcfg, tcfg


def _heatmaps(rng, shape):
    hm = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    return hm / hm.sum(axis=(-2, -1), keepdims=True)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(8)
    return {
        "video": rng.standard_normal((BATCH, 8, 32, 32, 3)).astype(np.float32),
        "audio": rng.standard_normal((BATCH, 8, 32, 32, 1)).astype(np.float32),
        "labels_hm": _heatmaps(rng, (BATCH, 8, 8, 8)),
    }


# ----------------------------------------------------------------------------------
# the layout: to_jax and the leaf names
# ----------------------------------------------------------------------------------


def _variant(name):
    if name == "flagship":
        return graft._flagship_cfg(), presets.flagship_cfg()
    jcfg, tcfg = _cfgs()
    if name == "joint_pos_embed":
        for c in (jcfg, tcfg):
            c.MVIT.SEP_POS_EMBED = False
            c.MVIT.QKV_BIAS = False
            c.MODEL.LOSS_FUNC = "kldiv"
    return jcfg, tcfg


@pytest.mark.parametrize("variant", ["small", "joint_pos_embed"])
def test_to_jax_inverts_from_jax(variant):
    jcfg, _ = _variant(variant)
    params = _np(jcsts.csts_init(jax.random.PRNGKey(3), jcsts.build_spec(jcfg)))
    back = to_jax.params_from_state_dict(state_dict_from_jax(params))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = to_jax.flatten(back)
    assert [n for n, _ in got] == ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                                            for p in path) for path, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("variant", ["small", "joint_pos_embed", "flagship"])
def test_param_leaf_names_match_jax(variant):
    jcfg, tcfg = _variant(variant)
    assert to_jax.param_leaf_names(tcfg) == jcu.param_leaf_names(jcfg)


def test_layout_takes_each_parameter_once():
    """``layout``: every parameter of the model once, each permutation a
    linear's (1, 0), a convolution's (2, 3, 4, 1, 0) or none."""
    _, tcfg = _cfgs()
    names = [n for n, _ in CSTS(build_spec(tcfg)).named_parameters()]
    lay = to_jax.layout(names)
    assert sorted(leaf.name for _, leaf in lay) == sorted(names)
    assert {leaf.perm for _, leaf in lay} == {None, to_jax.LINEAR, to_jax.CONV}


# ----------------------------------------------------------------------------------
# npz TrainState interop
# ----------------------------------------------------------------------------------

COMBOS = [(False, False), (True, False), (False, True), (True, True)]
IDS = ["plain", "ema", "bf16_moments", "ema_bf16_moments"]
_JAX_STEPS: dict = {}


def _jax_side(ema, bf16):
    """JAX's state and its compiled step for one (EMA, BF16_MOMENTS) pair,
    built once per module and shared by both directions."""
    if (ema, bf16) not in _JAX_STEPS:
        jcfg, _ = _cfgs(EMA_DECAY=0.9 if ema else 0.0, BF16_MOMENTS=bf16)
        jspec = jcsts.build_spec(jcfg)
        state, tx = jstep.create_train_state(jcfg, jspec, jax.random.PRNGKey(0))
        step = jstep.make_train_step(jcfg, jspec, tx, steps_per_epoch=10)
        _JAX_STEPS[(ema, bf16)] = (jcfg, jspec, state, step)
    jcfg, jspec, state, step = _JAX_STEPS[(ema, bf16)]
    # the step donates its state: hand out a copy
    return jcfg, jspec, jax.tree_util.tree_map(jnp.copy, state), step


def _port_state(tcfg, params):
    return tstep.create_train_state(tcfg, build_spec(tcfg),
                                    state_dict=state_dict_from_jax(_np(params)), device="cpu")


def _assert_state_equal(tstate, jstate, bf16):
    """The port's state against a JAX TrainState, exactly, after the layout."""
    leaves = tcu.state_leaves(tstate)
    want = jax.tree_util.tree_leaves(_np(jstate))
    assert len(leaves) == len(want)
    for i, (g, w) in enumerate(zip(leaves, want)):
        assert g.shape == w.shape, i
        w32 = np.asarray(w).astype(np.float32) if w.dtype != np.int32 else w
        if bf16 and w.dtype != np.int32 and w.dtype != np.float32:
            assert str(w.dtype) == "bfloat16"
        np.testing.assert_array_equal(g, w32, err_msg=f"leaf {i}")


def _further_step_agrees(tcfg, tstate, jstep_fn, jstate, batch):
    """One more step on each side: stats within 1e-4 relative, every weight
    within 2·BASE_LR (test_torch_train.py's bar for a second step)."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, jstats, _ = jstep_fn(jstate, jbatch, jax.random.PRNGKey(5))
    stats, _ = tstep.make_train_step(tcfg, build_spec(tcfg), steps_per_epoch=10)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    for name in ("loss", "kldiv_loss", "egonce_loss", "grad_norm", "lr"):
        assert float(stats[name]) == pytest.approx(float(jstats[name]), rel=1e-4), name
    want = state_dict_from_jax(_np(jstate.params))
    bar = 2 * tcfg.SOLVER.BASE_LR
    for n, p in tstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=bar, rtol=0,
                                   err_msg=n)
    if tstate.ema is not None:
        want = state_dict_from_jax(_np(jstate.ema))
        for n, e in tstate.ema.items():
            np.testing.assert_allclose(e.numpy(), want[n].numpy(), atol=bar, rtol=0, err_msg=n)


@pytest.mark.parametrize("ema,bf16", COMBOS, ids=IDS)
def test_jax_npz_loads_into_port(ema, bf16, batch, tmp_path):
    jcfg, jspec, jstate, step = _jax_side(ema, bf16)
    _, tcfg = _cfgs(EMA_DECAY=0.9 if ema else 0.0, BF16_MOMENTS=bf16)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate, _, _ = step(jstate, jbatch, jax.random.PRNGKey(4))  # moments and counts set
    path = jcu.save_checkpoint(str(tmp_path), _np(jstate), 3, jcfg, iter_idx=1)
    if bf16:
        # the JAX package writes its bf16 moments as raw |V2 leaves, which its
        # own loader refuses; the port reads them
        assert np.load(path)[f"leaf_{len(jcu.param_leaf_names(jcfg)) + 3:05d}"].dtype.kind == "V"
    tstate = tstep.create_train_state(tcfg, build_spec(tcfg),
                                      torch.Generator().manual_seed(1), device="cpu")
    assert tcu.load_checkpoint(path, tstate) == 3
    assert tcu.checkpoint_meta(path)["iter"] == 1
    assert tstate.step == 1 and tstate.optimizer.lr == pytest.approx(float(
        jstate.opt_state.hyperparams["learning_rate"]), rel=0)
    _assert_state_equal(tstate, jstate, bf16)
    if bf16:
        count, first, _ = tstate.optimizer.moments()
        assert count == 1 and all(m.dtype == torch.bfloat16 for m in first.values())
    _further_step_agrees(tcfg, tstate, step, jstate, batch)


@pytest.mark.parametrize("ema,bf16", COMBOS, ids=IDS)
def test_port_npz_loads_into_jax(ema, bf16, batch, tmp_path):
    jcfg, jspec, template, step = _jax_side(ema, bf16)
    _, tcfg = _cfgs(EMA_DECAY=0.9 if ema else 0.0, BF16_MOMENTS=bf16)
    tstate = _port_state(tcfg, template.params)
    tstep.make_train_step(tcfg, build_spec(tcfg), steps_per_epoch=10)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    path = tcu.save_checkpoint(str(tmp_path), tstate, 0, tcfg)
    p = len(to_jax.param_leaf_names(tcfg))
    assert len(np.load(path).files) == (4 if ema else 3) * p + 4
    assert tcu.checkpoint_meta(path)["num_leaves"] == len(np.load(path).files)
    loaded, epoch = jcu.load_checkpoint(path, template)  # its count and shape asserts
    assert epoch == 0 and int(loaded.step) == 1
    assert all(leaf.dtype == old.dtype for leaf, old in zip(
        jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(template)))
    _assert_state_equal(tstate, loaded, bf16)
    _further_step_agrees(tcfg, tstate, step, loaded, batch)


def test_load_checkpoint_refuses_another_layout(tmp_path):
    """A leaf count or a shape the configuration does not build raises."""
    _, tcfg = _cfgs(EMA_DECAY=0.9)
    state = tstep.create_train_state(tcfg, build_spec(tcfg), torch.Generator().manual_seed(0),
                                     device="cpu")
    path = tcu.save_checkpoint(str(tmp_path), state, 0)
    _, plain_cfg = _cfgs()
    plain = tstep.create_train_state(plain_cfg, build_spec(plain_cfg),
                                     torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        tcu.load_checkpoint(path, plain)
    wide_cfg = presets.small_cfg(BATCH)
    wide_cfg.MVIT.EMBED_DIM = 32
    wide_cfg.SOLVER.EMA_DECAY = 0.9
    wide = tstep.create_train_state(wide_cfg, build_spec(wide_cfg),
                                    torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tcu.load_checkpoint(path, wide)


def test_train_chain_resumes_the_newest_and_resets(tmp_path):
    """Auto-resume takes OUTPUT_DIR's newest file (a mid-epoch save sorts
    after its epoch's start and before the next epoch), with ``iter`` from
    its sidecar; an npz TRAIN path restarts at epoch 0 with
    CHECKPOINT_EPOCH_RESET and after its epoch without."""
    _, tcfg = _cfgs()
    tcfg.OUTPUT_DIR = str(tmp_path / "run")
    spec = build_spec(tcfg)
    state = tstep.create_train_state(tcfg, spec, torch.Generator().manual_seed(0), device="cpu")
    tcu.save_checkpoint(tcfg.OUTPUT_DIR, state, 1)
    state.step = 7
    newest = tcu.save_checkpoint(tcfg.OUTPUT_DIR, state, 1, iter_idx=3)
    assert tcu.get_last_checkpoint(tcfg.OUTPUT_DIR) == newest
    fresh = tstep.create_train_state(tcfg, spec, torch.Generator().manual_seed(1), device="cpu")
    assert tcu.load_train_checkpoint(tcfg, fresh) == (2, 3) and fresh.step == 7

    tcfg.TRAIN.AUTO_RESUME = False
    tcfg.TRAIN.CHECKPOINT_FILE_PATH = newest
    assert tcu.load_train_checkpoint(tcfg, fresh) == (2, 0)
    tcfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    assert tcu.load_train_checkpoint(tcfg, fresh) == (0, 0)
    tcfg.TRAIN.CHECKPOINT_FILE_PATH = ""
    assert tcu.load_train_checkpoint(tcfg, fresh) == (0, 0)


# ----------------------------------------------------------------------------------
# .pyth fine-tune init
# ----------------------------------------------------------------------------------


@pytest.mark.parametrize("target", [1, 7, 64, 144, 300])
def test_interpolate_pos_embed_matches_jax(target):
    src = np.random.default_rng(target).standard_normal((1, 64, 24)).astype(np.float32)
    got = from_torch.interpolate_pos_embed(src, target)
    np.testing.assert_array_equal(got, jfrom_torch.interpolate_pos_embed(src, target))
    if target == 64:
        np.testing.assert_array_equal(got, src)


def _pyth(path, sd):
    torch.save({"model_state": {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
                "epoch": 3}, path)


@pytest.mark.parametrize("ema", [False, True], ids=["no_ema", "ema"])
def test_pyth_fine_tune_init_matches_jax(ema, tmp_path):
    """A 48-crop checkpoint into a 32-crop model: the spatial position
    embeddings are interpolated (144 -> 64 tokens), ``vision_pool`` (its
    kernel spans the fusion grid) keeps its initialisation, everything else
    loads; then an audio-pretrained MViT (``blocks.*``, ``patch_embed.*``,
    ``pos_embed_*``, a head that is dropped) merges into the audio branch.
    The port's weights equal the JAX path's within 1e-7; the EMA restarts
    from them."""
    jcfg, tcfg = _cfgs(EMA_DECAY=0.9 if ema else 0.0)
    big, _ = _cfgs()
    big.DATA.TRAIN_CROP_SIZE = big.DATA.TEST_CROP_SIZE = 48
    video_sd = export_csts_state_dict(_np(jcsts.csts_init(jax.random.PRNGKey(11),
                                                          jcsts.build_spec(big))))
    main = str(tmp_path / "k400.pyth")
    _pyth(main, {("module." + k if i % 2 else k): v for i, (k, v) in enumerate(video_sd.items())})
    audio_src = export_csts_state_dict(_np(jcsts.csts_init(jax.random.PRNGKey(12),
                                                           jcsts.build_spec(jcfg))))
    audio_sd = {"head.projection.weight": np.ones((3, 4), np.float32)}
    for k, v in audio_src.items():
        if k.startswith("blocks_audio."):
            audio_sd["blocks." + k[len("blocks_audio."):]] = v
        elif k.startswith("patch_embed_audio."):
            audio_sd["patch_embed." + k[len("patch_embed_audio."):]] = v
        elif k in ("pos_embed_spatial_audio", "pos_embed_temporal_audio"):
            audio_sd[k[:-len("_audio")]] = v
    audio = str(tmp_path / "audio.pyth")
    _pyth(audio, audio_sd)
    for c in (jcfg, tcfg):
        c.OUTPUT_DIR = str(tmp_path / "out")
        c.TRAIN.CHECKPOINT_FILE_PATH = main
        c.TRAIN.AUDIO_CHECKPOINT_FILE_PATH = audio

    state, _ = jstep.create_train_state(jcfg, jcsts.build_spec(jcfg), jax.random.PRNGKey(0))
    init = state_dict_from_jax(_np(state.params))
    jstate, start, it = jcu.load_train_checkpoint(jcfg, state)
    tstate = _port_state(tcfg, state.params)
    assert tcu.load_train_checkpoint(tcfg, tstate) == (start, it) == (0, 0)
    want = state_dict_from_jax(_np(jstate.params))
    for n, p in tstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-7, rtol=0,
                                   err_msg=n)
    got = dict(tstate.model.named_parameters())
    assert not torch.equal(got["pos_embed_spatial"].detach(), init["pos_embed_spatial"])
    torch.testing.assert_close(got["vision_pool.weight"].detach(), init["vision_pool.weight"],
                               rtol=0, atol=0)
    assert torch.equal(got["blocks_audio.0.attn.qkv.weight"].detach(),
                       torch.as_tensor(audio_src["blocks_audio.0.attn.qkv.weight"]))
    if ema:
        for n, p in got.items():
            assert torch.equal(tstate.ema[n], p.detach()), n


# ----------------------------------------------------------------------------------
# the test chain on an npz
# ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("split"))
    return write_dataset(root, "ego4d", num_clips=4, res=(32, 48), seed=21)


def _tester_cfgs(split, out, npz, use_ema):
    prefix, splits = split
    pair = graft._small_cfg(4), presets.small_cfg(4)
    for c in pair:
        c.DATA.PATH_PREFIX, c.DATA.PATH_TO_DATA_DIR = prefix, splits
        c.DATA.DECODING_BACKEND = "npy"
        c.DATA.GAUSSIAN_KERNEL = 5
        c.TRAIN.ENABLE = False
        c.TEST.BATCH_SIZE = 4
        c.TEST.NUM_ENSEMBLE_VIEWS = c.TEST.NUM_SPATIAL_CROPS = 1
        c.TEST.CHECKPOINT_FILE_PATH = npz
        c.TEST.USE_EMA = use_ema
        c.SOLVER.EMA_DECAY = 0.9
        c.DATA_LOADER.NUM_WORKERS = 0
        c.LOG_PERIOD = 1
    pair[0].OUTPUT_DIR, pair[1].OUTPUT_DIR = str(out / "jax"), str(out / "port")
    return pair


@pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema"])
def test_tester_scores_a_jax_npz_as_jax_does(split, tmp_path, use_ema):
    jcfg, _ = _tester_cfgs(split, tmp_path, "", use_ema)
    state, _ = jstep.create_train_state(jcfg, jcsts.build_spec(jcfg), jax.random.PRNGKey(0))
    # EMA weights other than the params: another init
    ema = jcsts.csts_init(jax.random.PRNGKey(9), jcsts.build_spec(jcfg))
    state = jstep.TrainState(state.params, state.opt_state, state.step, ema)
    npz = jcu.save_checkpoint(str(tmp_path / "ckpt"), _np(state), 4, jcfg)
    jcfg, tcfg = _tester_cfgs(split, tmp_path, npz, use_ema)
    want = jax_test(jcfg)
    got = port_test(tcfg, device="cpu")
    assert got["threshold"] == want["threshold"]
    for k in ("f1", "recall", "precision", "auc"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    with open(os.path.join(tcfg.OUTPUT_DIR, "stdout.log")) as f:
        assert ("Evaluating the EMA weights" in f.read()) == use_ema
    model = CSTS(build_spec(tcfg))
    assert tcu.load_params_npz(npz, model, use_ema=use_ema) == use_ema
    src = ema if use_ema else state.params
    want_sd = state_dict_from_jax(_np(src))
    assert all(torch.equal(p.detach(), want_sd[n]) for n, p in model.named_parameters())


def test_test_chain_takes_ema_from_the_train_path_too(tmp_path, caplog):
    """TEST.USE_EMA reads the EMA leaves of whichever npz the chain picked,
    the TRAIN.CHECKPOINT_FILE_PATH fallback included (the JAX tester
    evaluates that file's raw params); a file without them warns."""
    _, tcfg = _cfgs(EMA_DECAY=0.5)
    spec = build_spec(tcfg)
    state = tstep.create_train_state(tcfg, spec, torch.Generator().manual_seed(0), device="cpu")
    for e in state.ema.values():
        e.add_(1.0)
    path = tcu.save_checkpoint(str(tmp_path / "a"), state, 0)
    tcfg.OUTPUT_DIR = str(tmp_path / "empty")
    tcfg.TRAIN.CHECKPOINT_FILE_PATH = path
    tcfg.TEST.USE_EMA = True
    model = CSTS(spec)
    assert tcu.load_test_checkpoint(tcfg, model) == path
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), state.ema[n]), n
    _, plain_cfg = _cfgs()
    plain = tstep.create_train_state(plain_cfg, spec, torch.Generator().manual_seed(0),
                                     device="cpu")
    tcfg.TRAIN.CHECKPOINT_FILE_PATH = tcu.save_checkpoint(str(tmp_path / "b"), plain, 0)
    caplog.set_level(logging.INFO)
    tcu.load_test_checkpoint(tcfg, model)
    assert "has no EMA weights" in caplog.text
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), dict(plain.model.named_parameters())[n].detach()), n

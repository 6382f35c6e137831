"""The PyTorch port's model against the JAX package on the CPU, fp32.

Weights come from the JAX ``csts_init``, go through the port's own converter
(``state_dict_from_jax``) and load with ``strict=True``; inputs come from
numpy with a seed and go through both packages.
"""

import dataclasses
import functools
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from csts_tpu.config import load_config as jax_load_config
from csts_tpu.convert.to_torch import export_csts_state_dict
from csts_tpu.models import csts as jcsts
from csts_tpu.serving import GazePredictor as JaxPredictor
from csts_torch import presets
from csts_torch.config import load_config
from csts_torch.convert.from_jax import state_dict_from_jax
from csts_torch.models import csts as tcsts
from csts_torch.serving import GazePredictor

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.yaml")))
LOGIT_TOL = 5e-4  # README.md:127, fp32 logits


def _cfg_pair(crop: int, batch: int = 2):
    jcfg, tcfg = graft._small_cfg(batch), presets.small_cfg(batch)
    for c in (jcfg, tcfg):
        c.DATA.TRAIN_CROP_SIZE = c.DATA.TEST_CROP_SIZE = crop
    return jcfg, tcfg


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_build_spec_matches_on_shipped_configs(path):
    jspec = jcsts.build_spec(jax_load_config(path))
    tspec = tcsts.build_spec(load_config(path))
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)


@pytest.mark.parametrize("crop", [32, 64])
def test_build_spec_matches_on_small_cfg(crop):
    jcfg, tcfg = _cfg_pair(crop)
    assert dataclasses.asdict(tcsts.build_spec(tcfg)) == dataclasses.asdict(jcsts.build_spec(jcfg))


def test_presets_match_graft_entry():
    assert presets.flagship_cfg().dump() == graft._flagship_cfg().dump()
    assert presets.small_cfg(4).dump() == graft._small_cfg(4).dump()


@pytest.fixture(scope="module", params=[32, 64])
def pair(request):
    crop = request.param
    jcfg, tcfg = _cfg_pair(crop)
    jspec = jcsts.build_spec(jcfg)
    params = jcsts.csts_init(jax.random.PRNGKey(0), jspec)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    model = tcsts.CSTS(tcsts.build_spec(tcfg))
    model.load_state_dict(state_dict_from_jax(params_np), strict=True)
    model.eval()
    rng = np.random.default_rng(crop)
    video = rng.standard_normal((2, 8, crop, crop, 3)).astype(np.float32)
    audio = rng.standard_normal((2, 8, 32, 32, 1)).astype(np.float32)
    jfwd = jax.jit(functools.partial(jcsts.csts_apply, spec=jspec, return_embed=True))
    return crop, jfwd, params, params_np, model, video, audio


def test_state_dict_matches_jax_exporter(pair):
    """The cross-check: the port's converter and the JAX package's exporter
    agree key for key and value for value."""
    _, _, _, params_np, model, _, _ = pair
    ours = state_dict_from_jax(params_np)
    theirs = export_csts_state_dict(params_np)
    assert sorted(ours) == sorted(theirs) == sorted(model.state_dict())
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_forward_matches_csts_apply(pair):
    crop, jfwd, params, _, model, video, audio = pair
    jl, jx, jy = jfwd(params, video=jnp.asarray(video), audio=jnp.asarray(audio))
    with torch.no_grad():
        tl, tx, ty = model(torch.from_numpy(video), torch.from_numpy(audio), return_embed=True)
    assert tuple(tl.shape) == (2, 8, crop // 4, crop // 4, 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=LOGIT_TOL, rtol=0)


def test_uint8_video_is_normalised_like_jax(pair):
    crop, jfwd, params, _, model, _, audio = pair
    video = np.random.default_rng(1).integers(0, 256, (2, 8, crop, crop, 3), dtype=np.uint8)
    jl, _, _ = jfwd(params, video=jnp.asarray(video), audio=jnp.asarray(audio))
    with torch.no_grad():
        tl = model(torch.from_numpy(video), torch.from_numpy(audio))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)


@pytest.fixture(scope="module")
def predictors():
    jcfg, tcfg = _cfg_pair(32, batch=8)
    params = jcsts.csts_init(jax.random.PRNGKey(1), jcsts.build_spec(jcfg))
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return (JaxPredictor(jcfg, params, batch_sizes=(8,)),
            GazePredictor(tcfg, sd, batch_sizes=(8,), device="cpu"))


@pytest.mark.parametrize("n", [1, 5])
def test_predict_matches_jax_predictor(predictors, n):
    """Bucket 8 pads n=1 and n=5 clips; heatmaps ≤1e-5, gaze points equal."""
    jpred, tpred = predictors
    rng = np.random.default_rng(10 + n)
    video = rng.standard_normal((n, 8, 32, 32, 3)).astype(np.float32)
    audio = rng.standard_normal((n, 8, 32, 32, 1)).astype(np.float32)
    want = jpred.predict(video, audio)
    got = tpred.predict(video, audio)
    assert got["heatmaps"].shape == (n, 8, 8, 8)
    np.testing.assert_allclose(got["heatmaps"], np.asarray(want["heatmaps"]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["gaze_xy"], want["gaze_xy"])


def test_from_checkpoint_reads_pyth_and_state_dict(tmp_path, predictors):
    _, tpred = predictors
    sd = tpred.model.state_dict()
    torch.save({"epoch": 3, "model_state": sd}, tmp_path / "w.pyth")
    torch.save(sd, tmp_path / "w.pt")
    rng = np.random.default_rng(3)
    video = rng.standard_normal((2, 8, 32, 32, 3)).astype(np.float32)
    audio = rng.standard_normal((2, 8, 32, 32, 1)).astype(np.float32)
    want = tpred.predict(video, audio)["heatmaps"]
    for name in ("w.pyth", "w.pt"):
        p = GazePredictor.from_checkpoint(tpred.cfg, str(tmp_path / name), batch_sizes=(8,),
                                          device="cpu")
        np.testing.assert_array_equal(p.predict(video, audio)["heatmaps"], want)

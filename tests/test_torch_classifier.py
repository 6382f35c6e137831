"""The MViT classifier family of the port (``csts_torch/models/mvit_classifier.py``,
``models/build.py``) and its cls-aware blocks against the JAX package on the
CPU, fp32.

Weights come from the JAX ``mvit_init`` (or ``multiscale_block_init``), go
through the port's own converter (``mvit_state_dict_from_jax``) and load with
``strict=True``; inputs come from numpy with a seed. The small config is
``tests/test_mvit_classifier.py``'s; the JAX side of each test sets the same
fields on ``csts_tpu.config.get_cfg()``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import csts_tpu.models  # noqa: F401  (registers the JAX builders)
from csts_tpu.config import get_cfg as jax_get_cfg
from csts_tpu.convert.from_torch import _linear as jax_linear
from csts_tpu.convert.from_torch import _norm as jax_norm
from csts_tpu.convert.from_torch import convert_csts_state_dict
from csts_tpu.models import mvit as jmvit
from csts_tpu.models.build import build_model as jax_build_model
import csts_torch
from csts_torch import ops, presets
from csts_torch.config import get_cfg
from csts_torch.convert.from_jax import _block, mvit_state_dict_from_jax
from csts_torch.models import mvit as tmvit
from csts_torch.models.build import MODEL_REGISTRY, build_model
from csts_torch.models.csts import CSTS
from csts_torch.models.mvit_classifier import MViT, build_mvit_spec

torch.set_num_threads(2)

LOGIT_TOL = 5e-4  # README.md:127, fp32 logits
BLOCK_TOL = 2e-5  # tests/test_mvit_classifier.py's cls block against the reference


def _small(cfg, cls: bool, drop: bool = True):
    """tests/test_mvit_classifier.py's ``mvit_cfg`` (cls on or off); with
    ``drop`` off, zero drop-path and head-dropout rates."""
    cfg.DATA.TRAIN_CROP_SIZE = 32
    cfg.DATA.TEST_CROP_SIZE = 32
    cfg.DATA.NUM_FRAMES = 8
    cfg.MVIT.PATCH_PADDING = [1, 3, 3]
    cfg.MVIT.CLS_EMBED_ON = cls
    cfg.MVIT.SEP_POS_EMBED = True
    cfg.MVIT.DEPTH = 4
    cfg.MVIT.EMBED_DIM = 16
    cfg.MVIT.DIM_MUL = [[1, 2.0], [2, 2.0], [3, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0], [2, 2.0], [3, 2.0]]
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 8, 8]
    cfg.MVIT.POOL_Q_STRIDE = [[1, 1, 2, 2], [2, 1, 2, 2], [3, 1, 2, 2]]
    cfg.MODEL.MODEL_NAME = "MVIT"
    cfg.MODEL.NUM_CLASSES = 11
    if drop:
        cfg.MVIT.DROPPATH_RATE = 0.2
    else:
        cfg.MVIT.DROPPATH_RATE = 0.0
        cfg.MODEL.DROPOUT_RATE = 0.0
    return cfg


def _jax_mvit_b_cfg():
    """``presets.mvit_b_16x4_cfg`` on the JAX package's config."""
    cfg = jax_get_cfg()
    cfg.DATA.NUM_FRAMES = 16
    cfg.DATA.SAMPLING_RATE = 4
    cfg.DATA.TRAIN_CROP_SIZE = 224
    cfg.DATA.TEST_CROP_SIZE = 224
    cfg.MVIT.PATCH_KERNEL = [3, 7, 7]
    cfg.MVIT.PATCH_STRIDE = [2, 4, 4]
    cfg.MVIT.PATCH_PADDING = [1, 3, 3]
    cfg.MVIT.DEPTH = 16
    cfg.MVIT.NUM_HEADS = 1
    cfg.MVIT.EMBED_DIM = 96
    cfg.MVIT.MLP_RATIO = 4.0
    cfg.MVIT.QKV_BIAS = True
    cfg.MVIT.DROPPATH_RATE = 0.2
    cfg.MVIT.DIM_MUL = [[1, 2.0], [3, 2.0], [14, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0], [3, 2.0], [14, 2.0]]
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 8, 8]
    cfg.MVIT.POOL_Q_STRIDE = [[1, 1, 2, 2], [3, 1, 2, 2], [14, 1, 2, 2]]
    cfg.MVIT.CLS_EMBED_ON = True
    cfg.MVIT.SEP_POS_EMBED = True
    cfg.MODEL.MODEL_NAME = "MVIT"
    cfg.MODEL.NUM_CLASSES = 400
    cfg.MODEL.DROPOUT_RATE = 0.5
    cfg.MODEL.HEAD_ACT = "softmax"
    return cfg


def _pair(jcfg, tcfg, seed: int = 0):
    jspec, init_fn, apply_fn = jax_build_model(jcfg)
    params = jax.tree_util.tree_map(np.asarray, init_fn(jax.random.PRNGKey(seed)))
    model = build_model(tcfg, device="cpu").eval()
    model.load_state_dict(mvit_state_dict_from_jax(params), strict=True)
    return jspec, apply_fn, params, model


@pytest.fixture(scope="module", params=[True, False], ids=["cls", "no_cls"])
def pair(request):
    cls = request.param
    return (cls, *_pair(_small(jax_get_cfg(), cls), _small(get_cfg(), cls)))


def _video(seed: int, n: int = 2, crop: int = 32, t: int = 8) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, t, crop, crop, 3)).astype(np.float32)


def _jax_logits(apply_fn, params, video, **kw) -> np.ndarray:
    p = jax.tree_util.tree_map(jnp.asarray, params)
    return np.asarray(apply_fn(p, jnp.asarray(video), **kw))


# ----------------------------------------------------------------------------------
# the builder and the spec
# ----------------------------------------------------------------------------------


def test_build_model_builds_both_families(monkeypatch):
    assert "CSTS" in MODEL_REGISTRY
    csts_cfg = presets.small_cfg(1)
    model = build_model(csts_cfg, device="cpu")
    assert isinstance(model, CSTS) and "MVIT" in MODEL_REGISTRY
    assert isinstance(build_model(_small(get_cfg(), True), device="cpu"), MViT)
    # seeded from RNG_SEED: the same config gives the same weights
    again = build_model(csts_cfg, device="cpu")
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(csts_cfg)
    assert csts_torch.resolve_device("cpu").type == "cpu"
    bad = get_cfg()
    bad.MODEL.MODEL_NAME = "ResNet"
    with pytest.raises(KeyError, match="ResNet"):
        build_model(bad, device="cpu")


@pytest.mark.parametrize("cls", [True, False], ids=["cls", "no_cls"])
def test_spec_matches_jax(cls):
    jspec = jax_build_model(_small(jax_get_cfg(), cls))[0]
    tspec = build_mvit_spec(_small(get_cfg(), cls))
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert all(b.has_cls == cls for b in tspec.blocks)


def test_mvit_b_16x4_preset_matches_jax():
    cfg = presets.mvit_b_16x4_cfg()
    assert cfg.dump() == _jax_mvit_b_cfg().dump()
    spec = build_mvit_spec(cfg)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jax_build_model(_jax_mvit_b_cfg())[0])
    assert spec.patch_dims == (8, 56, 56) and len(spec.blocks) == 16
    assert [b.num_heads for b in spec.blocks] == [1, 2, 2, 4] + [4] * 10 + [8, 8]
    assert spec.blocks[-1].dim_out == 768 and spec.num_classes == 400


def test_mvit_b_16x4_routes():
    """The classifier's routes at 16x224², from ``block_route``: with
    the cls token every block takes K1+K2; without it B3 takes v0 and v2
    (Lk 392), K1+K2 the rest, B4 none (Lk 1568 > 1024 at v1, v3 and v14)."""
    for cls, want in ((True, ["composite"] * 16),
                      (False, ["block", "composite", "block"] + ["composite"] * 13)):
        cfg = presets.mvit_b_16x4_cfg()
        cfg.MVIT.CLS_EMBED_ON = cls
        spec = build_mvit_spec(cfg)
        thw, routes, lks = spec.patch_dims, [], []
        for b in spec.blocks:
            routes.append(tmvit.block_route(b, None, thw))
            lks.append(tmvit._lk(b, thw))
            if b.pool_q_on:
                thw = tmvit._static_pool_out(thw, b.kernel_q, b.stride_q, b.padding_q)
        assert routes == want, routes
        assert lks == [392, 1568, 392, 1568] + [392] * 10 + [1568, 392], lks


# ----------------------------------------------------------------------------------
# the converter
# ----------------------------------------------------------------------------------


def test_converter_key_for_key(pair):
    """The port's state dict has PySlowFast's MViT names; the JAX package's
    own converter takes it back to the tree ``mvit_init`` made, leaf for leaf."""
    cls, jspec, _, params, model = pair
    sd = mvit_state_dict_from_jax(params)
    assert sorted(sd) == sorted(model.state_dict())
    assert ("cls_token" in sd) == ("pos_embed_class" in sd) == cls
    assert {"patch_embed.proj.weight", "norm.weight", "head.projection.weight",
            "pos_embed_spatial", "pos_embed_temporal"} <= set(sd)
    np_sd = {k: v.numpy() for k, v in sd.items()}
    back = convert_csts_state_dict(np_sd, num_video_blocks=len(jspec.blocks),
                                   num_audio_blocks=0)
    back["norm"] = jax_norm(np_sd, "norm")
    back["head"] = jax_linear(np_sd, "head.projection")
    for name in ("cls_token", "pos_embed_class"):
        if name in np_sd:
            back[name] = np_sd[name]
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=jax.tree_util.keystr(path))


# ----------------------------------------------------------------------------------
# the forward
# ----------------------------------------------------------------------------------


def test_eval_logits_match_jax(pair):
    cls, _, apply_fn, params, model = pair
    video = _video(1)
    want = _jax_logits(apply_fn, params, video)
    with torch.no_grad():
        got = model(torch.from_numpy(video))
    assert tuple(got.shape) == (2, 11) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL, rtol=0)
    # logits, not probabilities: MODEL.HEAD_ACT is the caller's
    assert not np.allclose(got.numpy().sum(-1), 1.0)


@pytest.mark.parametrize("cls", [True, False], ids=["cls", "no_cls"])
def test_train_mode_with_zero_rates_equals_eval(cls):
    """At zero drop-path and dropout rates the training route (K1 with B8,
    the B7 tail, through autograd) gives eval's logits, and JAX's at
    ``deterministic=False``."""
    jspec, apply_fn, params, model = _pair(_small(jax_get_cfg(), cls, drop=False),
                                           _small(get_cfg(), cls, drop=False), seed=3)
    video = _video(4)
    with torch.no_grad():
        ev = model(torch.from_numpy(video))
    model.train()
    tr = model(torch.from_numpy(video))
    assert tr.requires_grad
    np.testing.assert_allclose(tr.detach().numpy(), ev.numpy(), atol=1e-5, rtol=0)
    want = _jax_logits(apply_fn, params, video, deterministic=False,
                       rng=jax.random.PRNGKey(5))
    np.testing.assert_allclose(tr.detach().numpy(), want, atol=LOGIT_TOL, rtol=0)
    tr.sum().backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


@pytest.mark.parametrize("cls", [True, False], ids=["cls", "no_cls"])
def test_train_mode_with_dropout_is_finite(cls):
    cfg = _small(get_cfg(), cls)
    model = build_model(cfg, device="cpu").train()
    spec = model.spec
    video = torch.from_numpy(_video(6))
    with pytest.raises(ValueError, match="generator"):
        model(video)
    drop = ops.sample_drop_masks(spec.blocks, 2, torch.Generator().manual_seed(1))
    assert sum(d is not None for d in drop) == len(spec.blocks) - 1  # block 0's rate is 0
    a = model(video, drop=drop, generator=torch.Generator().manual_seed(2))
    b = model(video, drop=drop, generator=torch.Generator().manual_seed(2))
    c = model(video, drop=drop, generator=torch.Generator().manual_seed(3))
    assert bool(torch.isfinite(a).all()) and torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        ev = model.eval()(video)
    assert not torch.allclose(a.detach(), ev)


def test_bf16_forward_follows_mixed_precision():
    """The compute dtype follows TRAIN.MIXED_PRECISION (bf16 activations over
    fp32 weights), as the JAX ``mvit_apply``."""
    cfg = _small(get_cfg(), True)
    cfg.TRAIN.MIXED_PRECISION = True
    model = build_model(cfg, device="cpu").eval()
    assert model.spec.compute_dtype == torch.bfloat16
    ref = build_model(_small(get_cfg(), True), device="cpu").eval()
    ref.load_state_dict(model.state_dict())
    video = torch.from_numpy(_video(7))
    with torch.no_grad():
        out, out32 = model(video), ref(video)
    assert out.dtype == torch.bfloat16 and out32.dtype == torch.float32
    assert float((out.float() - out32).abs().max()) < 0.05 * max(1.0, float(out32.abs().max()))


# ----------------------------------------------------------------------------------
# one cls-aware block against multiscale_block_apply
# ----------------------------------------------------------------------------------

BLOCKS = {
    # the reference test's Q-pool block (tests/test_mvit_classifier.py::test_cls_block_parity)
    "qpool_96_192": dict(dim=96, dim_out=192, num_heads=2, kernel_q=(3, 3, 3),
                         kernel_kv=(3, 3, 3), stride_q=(1, 2, 2), stride_kv=(1, 4, 4)),
    # a K/V-pool-only block and a T-stride Q pool, narrow
    "kvpool_32": dict(dim=32, dim_out=32, num_heads=2, kernel_kv=(3, 3, 3),
                      stride_kv=(1, 2, 2)),
    "qpool_t2_16_32": dict(dim=16, dim_out=32, num_heads=1, kernel_q=(3, 3, 3),
                           kernel_kv=(3, 3, 3), stride_q=(2, 2, 2), stride_kv=(2, 4, 4)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_cls_block_matches_jax(name, train):
    kw = BLOCKS[name]
    jspec = jmvit.AttentionSpec(has_cls=True, **kw)
    tspec = tmvit.AttentionSpec(has_cls=True, **kw)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    p = jmvit.multiscale_block_init(jax.random.PRNGKey(7), jspec)
    p_np = jax.tree_util.tree_map(np.asarray, p)
    sd = {}
    _block(sd, "b", p_np)
    blk = tmvit.MultiScaleBlock(tspec)
    blk.load_state_dict({k[2:]: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                        strict=True)
    blk.train(train)
    thw = (2, 8, 8)
    x = np.random.default_rng(8).standard_normal((2, 1 + 2 * 8 * 8, kw["dim"])).astype(np.float32)
    want, want_thw = jmvit.multiscale_block_apply(p, jspec, jnp.asarray(x), thw,
                                                  deterministic=not train)
    assert tmvit.block_route(tspec, None, thw) == "composite"
    got, got_thw = blk(torch.from_numpy(x), thw)
    assert tuple(got_thw) == tuple(want_thw)
    assert tuple(got.shape) == want.shape == (2, 1 + int(np.prod(want_thw)), kw["dim_out"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=BLOCK_TOL, rtol=0)


def test_cls_token_bypasses_the_pools():
    """The leading token is not pooled: changing only it leaves the pooled
    skip's other rows and the pooled keys' other rows unchanged."""
    x = torch.randn(2, 1 + 2 * 4 * 4, 8, generator=torch.Generator().manual_seed(0))
    y = x.clone()
    y[:, 0] += 100.0
    a, thw = tmvit.pool_tokens_max(x, (2, 4, 4), (1, 3, 3), (1, 2, 2), (0, 1, 1), has_cls=True)
    b, _ = tmvit.pool_tokens_max(y, (2, 4, 4), (1, 3, 3), (1, 2, 2), (0, 1, 1), has_cls=True)
    assert thw == (2, 2, 2) and a.shape == (2, 9, 8)
    assert torch.equal(a[:, 1:], b[:, 1:]) and torch.equal(b[:, 0], y[:, 0])


@pytest.mark.slow
def test_mvit_b_16x4_full_width_matches_jax():
    """The published MViT-B 16x4 (16x224², cls on) at batch 1, fp32, on the CPU."""
    jspec, apply_fn, params, model = _pair(_jax_mvit_b_cfg(), presets.mvit_b_16x4_cfg(), seed=11)
    video = _video(12, n=1, crop=224, t=16)
    want = np.asarray(jax.jit(lambda p, v: apply_fn(p, v))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(video)))
    with torch.no_grad():
        got = model(torch.from_numpy(video))
    assert tuple(got.shape) == (1, 400)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL, rtol=0)

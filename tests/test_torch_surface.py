"""The forward's whole surface against the JAX package on the CPU, fp32, at
``small_cfg`` (crop 32): the fusion blocks' attention maps, the captured
activations, MVIT.SPATIAL_AUDIO_ATTN at eval and in a training step, and
the A/B switches.

Tolerance: 5e-4 absolute on logits, maps and activations (the fp32 bar of
``test_torch_model.py``; the two packages sum in other orders, ~1e-6
apart); gradients at ``test_torch_train.py``'s bar (atol 2e-4, rtol 2e-3).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from csts_tpu.kernels import upsample as jup
from csts_tpu.models import csts as jcsts
from csts_tpu.ops import resize as jresize
from csts_tpu.train import losses as jlosses
from csts_torch import presets
from csts_torch.convert.from_jax import state_dict_from_jax
from csts_torch.kernels import upsample as kup
from csts_torch.models import csts as tcsts
from csts_torch.models import mvit as tmvit
from csts_torch.tools import ab_flags
from csts_torch.train import step as tstep

torch.set_num_threads(2)

TOL = 5e-4
BATCH = 2


def _cfgs(audio_attn: bool = False):
    jcfg, tcfg = graft._small_cfg(BATCH), presets.small_cfg(BATCH)
    for c in (jcfg, tcfg):
        c.MVIT.SPATIAL_AUDIO_ATTN = audio_attn
        c.MVIT.DROPPATH_RATE = 0.0
    return jcfg, tcfg


def _setup(audio_attn: bool = False):
    jcfg, tcfg = _cfgs(audio_attn)
    jspec = jcsts.build_spec(jcfg)
    params = jcsts.csts_init(jax.random.PRNGKey(0), jspec)
    model = tcsts.CSTS(tcsts.build_spec(tcfg))
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    return jcfg, tcfg, jspec, params, model.eval()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((BATCH, 8, 32, 32, 3)).astype(np.float32),
            rng.standard_normal((BATCH, 8, 32, 32, 1)).astype(np.float32))


@pytest.fixture(scope="module")
def base():
    return _setup()


def _jax_surface(params, jspec, video, audio, **flags):
    """csts_apply with both maps and the activations captured, jitted anew
    (the module switches are read when it traces)."""

    def run(p, v, a):
        acts: dict = {}
        out = jcsts.csts_apply(p, jspec, v, a, return_spatial_attn=True,
                               return_temporal_attn=True, capture=acts)
        return out, acts

    return jax.jit(run)(params, jnp.asarray(video), jnp.asarray(audio))


def _close(got: torch.Tensor, want, name: str) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), atol=TOL, rtol=0,
                               err_msg=name)


def test_maps_and_activations_match_csts_apply(base, inputs):
    """Logits with both maps (the spatial fusion's (B, N, L, L), L = T·H·W + T,
    and the temporal fusion's (B, N, 2T, 2T), fp32) in JAX's order, and
    ``extract_activations`` layer for layer, all of CAPTURABLE."""
    _, _, jspec, params, model = base
    video, audio = inputs
    (jl, js, jt), jacts = _jax_surface(params, jspec, video, audio)
    v, a = torch.from_numpy(video), torch.from_numpy(audio)
    with torch.no_grad():
        out = model(v, a, return_spatial_attn=True, return_temporal_attn=True)
        only_t = model(v, a, return_temporal_attn=True)
        plain = model(v, a)
        logits, acts = tcsts.extract_activations(model, v, a)
        some = tcsts.extract_activations(model, v, a, layers=("blocks/1", "spatial_fusion"))[1]
    assert isinstance(out, list) and len(out) == 3 and len(only_t) == 2
    t, h, w = jspec.fusion_thw
    n = jspec.spatial_fusion.num_heads
    assert tuple(out[1].shape) == (BATCH, n, t * h * w + t, t * h * w + t)
    assert tuple(out[2].shape) == (BATCH, jspec.temporal_fusion.num_heads, 2 * t, 2 * t)
    assert out[1].dtype == out[2].dtype == torch.float32
    for got, want, name in zip(out, (jl, js, jt), ("logits", "spatial", "temporal")):
        _close(got, want, name)
    _close(only_t[1], jt, "temporal alone")
    torch.testing.assert_close(out[0], plain, rtol=0, atol=0)  # the maps move no logit
    torch.testing.assert_close(logits, plain, rtol=0, atol=0)
    assert sorted(acts) == sorted(jacts) and len(acts) == 2 + 4 + 4 + 2 + 4
    for name, want in jacts.items():
        _close(acts[name], want, name)
    assert sorted(some) == ["blocks/1", "spatial_fusion"]
    rows = tmvit.extract_audio_attention(out[1], jspec.fusion_thw)
    assert tuple(rows.shape) == (BATCH, n, t, h, w)
    assert float(rows.amin()) >= 0 and float(rows.amax()) <= 1 + 1e-6


def test_attention_map_route(base):
    """``block_route`` sends a block asked for its map to "attn_map" (the
    plain core, its probabilities summing to 1 on every row) and leaves the
    others on their kernel routes."""
    _, _, jspec, _, model = base
    spec = model.spec
    assert tmvit.block_route(spec.spatial_fusion, model.inframe_mask, spec.fusion_thw) \
        == "composite"
    assert tmvit.block_route(spec.spatial_fusion, None, spec.fusion_thw, return_attn=True) \
        == "attn_map"
    q, k, v = (torch.randn(2, 3, 5, 8) for _ in range(3))
    out, p = tmvit.attention_probs(q, k, v, 8 ** -0.5)
    torch.testing.assert_close(p.sum(-1), torch.ones(2, 3, 5))
    from csts_torch.kernels import attention as ka

    torch.testing.assert_close(out, ka.fused_attention_plain(q, k, v, 8 ** -0.5))


def test_get_weights(base):
    _, _, _, _, model = base
    got = tcsts.get_weights(model, ("blocks/1/attn/qkv", "classifier/weight"))
    assert sorted(got["blocks/1/attn/qkv"]) == ["bias", "weight"]
    assert got["classifier/weight"] is model.classifier.weight


def test_spatial_audio_attn_at_eval(inputs):
    """MVIT.SPATIAL_AUDIO_ATTN: the spatial fusion's audio→video maps scale
    the temporal branch; logits and embeddings against csts_apply."""
    _, _, jspec, params, model = _setup(audio_attn=True)
    video, audio = inputs
    jl, jx, jy = jax.jit(functools.partial(jcsts.csts_apply, spec=jspec, return_embed=True))(
        params, video=jnp.asarray(video), audio=jnp.asarray(audio))
    with torch.no_grad():
        tl, tx, ty = model(torch.from_numpy(video), torch.from_numpy(audio), return_embed=True)
    for got, want, name in ((tl, jl, "logits"), (tx, jx, "vision"), (ty, jy, "audio")):
        _close(got, want, name)
    _, _, _, _, off = _setup(audio_attn=False)
    with torch.no_grad():
        assert float((off(torch.from_numpy(video), torch.from_numpy(audio)) - tl).abs().max()) > TOL


def test_spatial_audio_attn_training_step(inputs):
    """One training step with MVIT.SPATIAL_AUDIO_ATTN (kldiv+egonce, no
    stochastic depth): the objective and every parameter's gradient against
    jax.value_and_grad of make_train_step's objective (the gradient flows
    through the spatial fusion's probabilities into the temporal branch),
    then the port's whole step: its loss the same, finite."""
    jcfg, tcfg, jspec, params, _ = _setup(audio_attn=True)
    video, audio = inputs
    labels = np.random.default_rng(3).random((BATCH, 8, 8, 8)).astype(np.float32)
    labels /= labels.sum(axis=(2, 3), keepdims=True)
    alpha = jcfg.MODEL.LOSS_ALPHA

    def loss_fn(p, v, a, hm):
        logits, x, y = jcsts.csts_apply(p, jspec, v, a, deterministic=False,
                                        rng=jax.random.PRNGKey(1), return_embed=True)
        kl = jlosses.kldiv_loss(jlosses.frame_softmax(logits, temperature=2.0), hm)
        return kl + alpha * jlosses.egonce_loss(jlosses.sim_matrix(x, y))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        params, jnp.asarray(video), jnp.asarray(audio), jnp.asarray(labels))
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    batch = {"video": torch.from_numpy(video), "audio": torch.from_numpy(audio),
             "labels_hm": torch.from_numpy(labels)}
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    state = tstep.create_train_state(tcfg, tcsts.build_spec(tcfg), state_dict=sd, device="cpu")
    got, _, _ = tstep.forward_loss(tcfg, state.model.train(), batch, None)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(loss), rel=1e-5)
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), atol=2e-4, rtol=2e-3,
                                   err_msg=n)
    state.model.zero_grad(set_to_none=True)
    stats, _ = tstep.make_train_step(tcfg, tcsts.build_spec(tcfg), steps_per_epoch=10)(
        state, batch, None)
    assert float(stats["loss"]) == pytest.approx(float(loss), rel=1e-5)
    assert np.isfinite(float(stats["grad_norm"]))


# each switch flipped from the defaults, in both packages
SWITCHES = {
    "head_commute": ((jcsts, "HEAD_COMMUTE"), "t2_skip"),
    "t2_skip": ((jup, "T2_SKIP_KERNEL"), "head_commute"),
    "split_resize": ((jresize, "SPLIT_AXES_T_FIRST"), "head_commute+t2_skip"),
}


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_switch_flipped_matches_jax(base, inputs, switch, monkeypatch):
    """The port with one switch off (the others at their defaults) against
    the JAX package with the same switch off: logits and both maps. With
    t2_skip off no K3 launch happens (the wrappers' CPU counters stay)."""
    _, _, jspec, params, model = base
    (mod, attr), port_conf = SWITCHES[switch]
    monkeypatch.setattr(mod, attr, False)
    video, audio = inputs
    (jl, js, jt), _ = _jax_surface(params, jspec, video, audio)
    calls = []
    monkeypatch.setattr(kup, "t2_upsample", lambda *a: calls.append(a) or kup.t2_upsample_plain(*a))
    with ab_flags.flags(port_conf), torch.no_grad():
        out = model(torch.from_numpy(video), torch.from_numpy(audio), return_spatial_attn=True,
                    return_temporal_attn=True)
    for got, want, name in zip(out, (jl, js, jt), ("logits", "spatial", "temporal")):
        _close(got, want, f"{switch} {name}")
    assert len(calls) == (0 if switch == "t2_skip" else 2), len(calls)

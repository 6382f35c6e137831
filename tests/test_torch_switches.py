"""The JAX package's kernel switches and the gradients behind them, against
the JAX package on the CPU.

* The switches (``kernels/attention.py``): JAX's names and signatures, the
  defaults (TRAIN_ATTN on is the port's recorded route difference; JAX's is
  off), ``set_enabled(False)`` sending the wrappers to their plain twins and
  the blocks to the composite route, ``set_enabled(None)``.
* K1 under autograd (``FusedAttention``: B8's backward unmasked, the plain
  recompute masked) against ``jax.grad`` through
  ``csts_tpu.kernels.attention.fused_attention(..., interpret=True)`` at
  ``tests/test_pallas_attention.py``'s shapes and bars (1e-4).
* K2 (``MlpTail``) and B3 (``FusedBlock``), the recompute backwards, against
  ``jax.grad`` through ``fused_mlp_tail`` and ``fused_block`` in interpret
  mode at ``tests/test_fused_block.py``'s cases and bars (1e-3), x and every
  weight.
* A decoder block under TRAIN_DECODER (``DecoderBlockTrain``) against
  ``mvit._decoder_block_ad`` with its kernels interpreted at
  ``tests/test_fused_block.py``'s ``DEC_CASES[2]``: the loss within 1e-5
  relative, x and every parameter's gradient within 2e-3.
* One ``small_cfg`` training step at crop 64 under each combination of
  TRAIN_ATTN and TRAIN_DECODER against ``make_train_step`` with the same
  ``ka.set_train_*`` settings and the JAX kernels enabled and interpreted.
  At crop 64 JAX's ``decoder_eligible`` admits d3 and d4 (d1 and d2 miss its
  128-lane tiling), so its TRAIN_DECODER step runs B5 twice and the
  comparison is not composite against composite; the port's predicate admits
  d1-d4. The bars are ``tests/test_torch_trainer.py``'s: the losses within
  1e-5 relative, the pre-clip gradient norm within 1e-3, each weight after
  the step within 2·BASE_LR.
* GradCache's two passes and MODEL.ACT_CHECKPOINT under TRAIN_DECODER take
  B5's route in both passes and give the gradients of the same step with the
  switch off (the port against itself, 1e-5).

Weights go from JAX's init to the port through ``convert/from_jax.py``.
All comparisons fp32.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from csts_tpu.kernels import attention as jka
from csts_tpu.kernels import block as jkb
from csts_tpu.kernels import upsample as jkup
from csts_tpu.models import csts as jcsts
from csts_tpu.models import mvit as jmvit
from csts_tpu.train import step as jstep
from csts_torch import presets
from csts_torch.convert.from_jax import _block, state_dict_from_jax
from csts_torch.kernels import attention as ka
from csts_torch.kernels import block as kb
from csts_torch.models import mvit as tmvit
from csts_torch.models.csts import build_spec
from csts_torch.train import step as tstep

torch.set_num_threads(2)

SWITCHES = ("enabled", "set_enabled", "train_attention_enabled", "set_train_attention",
            "train_decoder_enabled", "set_train_decoder")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _restore_switches(monkeypatch):
    """Every switch of both packages back to its value after each test."""
    for mod in (jka, ka):
        for name in ("_ENABLED", "_TRAIN_ATTN", "_TRAIN_DECODER"):
            monkeypatch.setattr(mod, name, getattr(mod, name))


def _interpret(monkeypatch, mod, name):
    """The JAX kernel wrapper ``mod.name`` run in interpret mode, as the JAX
    suite runs it on the CPU."""
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, interpret=False, **k: orig(*a, interpret=True, **k))


def _port_layout(tree, upsample: bool) -> dict:
    """A JAX block's tree (its params, or their gradients: the converter is
    linear) in the port's names and layouts, through ``convert/from_jax.py``."""
    sd = {}
    _block(sd, "b", jax.tree_util.tree_map(np.asarray, tree), upsample=upsample)
    return {k[2:]: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _pair(spec_kw: dict, seed: int):
    """One block in both packages: JAX's init, loaded into the port's
    ``MultiScaleBlock``."""
    jspec = jmvit.AttentionSpec(**spec_kw, fused=True)
    params = jmvit.multiscale_block_init(jax.random.PRNGKey(seed), jspec)
    block = tmvit.MultiScaleBlock(tmvit.AttentionSpec(**dataclasses.asdict(jspec)))
    block.load_state_dict(_port_layout(params, jspec.upsample_q), strict=True)
    return jspec, params, block


def _check_param_grads(block, jgrads, atol: float, rtol: float) -> None:
    """Every parameter's gradient of the port's block against JAX's (in the
    port's layout); a parameter the port gave none must have JAX's zero."""
    want = _port_layout(jgrads, block.spec.upsample_q)
    names = dict(block.named_parameters())
    assert set(names) == set(want)
    for n, p in names.items():
        if p.grad is None:
            assert not torch.any(want[n]), n
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), atol=atol, rtol=rtol,
                                   err_msg=n)


# --- the switches --------------------------------------------------------------


def test_switches_have_jax_names_and_defaults():
    """JAX's six functions with its signatures; the defaults: the kernels
    on, TRAIN_DECODER off (JAX's), TRAIN_ATTN on (the port's recorded route
    difference: JAX's default is off); set_enabled(None) restores the
    default, and each setter's value is read back."""
    for name in SWITCHES:
        assert list(inspect.signature(getattr(ka, name)).parameters) == list(
            inspect.signature(getattr(jka, name)).parameters), name
    assert ka.enabled() is True
    assert ka.train_decoder_enabled() is False and jka.train_decoder_enabled() is False
    assert ka.train_attention_enabled() is True and jka.train_attention_enabled() is False
    ka.set_enabled(False)
    assert ka.enabled() is False
    ka.set_enabled(True)
    assert ka.enabled() is True
    ka.set_enabled(None)
    assert ka.enabled() is True
    ka.set_train_attention(False)
    ka.set_train_decoder(True)
    assert (ka.train_attention_enabled(), ka.train_decoder_enabled()) == (False, True)


def test_kernels_off_take_the_composite_route_through_the_twins():
    """``set_enabled(False)``: a B3 block and a B5 block route "composite"
    at eval and "plain" in training; the wrappers return their plain twins
    (no autograd Function of a kernel in the graph); ``disabled()`` restores
    the switch."""
    b3 = tmvit.AttentionSpec(dim=96, dim_out=96, num_heads=1, kernel_kv=(3, 3, 3),
                             stride_kv=(1, 4, 4))
    b5 = tmvit.AttentionSpec(dim=192, dim_out=96, num_heads=2, kernel_q=(3, 3, 3),
                             kernel_kv=(3, 3, 3), stride_q=(2, 1, 1), stride_kv=(1, 4, 4),
                             upsample_q=True)
    thw = (4, 8, 16)
    assert tmvit.block_route(b3, None, thw) == "block"
    assert tmvit.block_route(b5, None, thw) == "decoder_block"
    assert tmvit.train_route(b5, None, thw) == "composite"
    ka.set_train_decoder(True)
    assert tmvit.train_route(b5, None, thw) == "decoder_block"
    assert tmvit.train_route(b5, None, thw, split=True) == "composite"
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 16, 8, generator=gen, requires_grad=True) for _ in range(3))
    assert type(ka.fused_attention(q, k, v, 0.3).grad_fn).__name__ == "FusedAttentionBackward"
    with ka.disabled():
        assert not ka.enabled()
        assert tmvit.block_route(b3, None, thw) == "composite"
        assert tmvit.block_route(b5, None, thw) == "composite"
        assert tmvit.train_route(b5, None, thw) == "plain"
        out = ka.fused_attention(q, k, v, 0.3)
        assert "FusedAttention" not in type(out.grad_fn).__name__
        torch.testing.assert_close(out, ka.fused_attention_plain(q, k, v, 0.3), rtol=0, atol=0)
        x = torch.randn(2, 16, 8, generator=gen, requires_grad=True)
        w = [torch.ones(8), torch.zeros(8), torch.randn(32, 8, generator=gen), torch.zeros(32),
             torch.randn(8, 32, generator=gen), torch.zeros(8), None, None]
        out = kb.mlp_tail_train(x, *w, torch.ones(2))
        assert "MlpTailTrain" not in type(out.grad_fn).__name__
        torch.testing.assert_close(out, kb.fused_mlp_tail_train_plain(x, *w, torch.ones(2))[0],
                                   rtol=0, atol=0)
    assert ka.enabled()


# --- the kernels' gradients ------------------------------------------------------


def _attention_grads(q, k, v, scale, mask=None):
    """The port's K1 under autograd: the gradients of sum(out²)."""
    leaves = [torch.from_numpy(np.array(t)).requires_grad_() for t in (q, k, v)]
    m = None if mask is None else torch.from_numpy(np.asarray(mask))
    out = ka.fused_attention(*leaves, scale, m)
    assert type(out.grad_fn).__name__ == "FusedAttentionBackward"
    out.square().sum().backward()
    return [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_attention_gradients_match_jax(rng, masked):
    """K1's gradients (B8 unmasked, the plain recompute masked) against
    ``jax.grad`` through the Pallas kernel in interpret mode at
    ``tests/test_pallas_attention.py``'s shapes (test_fused_gradients_match,
    test_masked_gradients_use_composite_fallback), atol and rtol 1e-4."""
    b, n, lq, lk, hd = (1, 2, 68, 68, 64) if masked else (1, 2, 128, 64, 32)
    q, k, v = (jnp.asarray(rng.standard_normal((b, n, length, hd)), jnp.float32)
               for length in (lq, lk, lk))
    mask = (jnp.asarray(np.asarray(jmvit.build_inframe_mask((4, 4, 4), 4), np.float32))
            if masked else None)
    scale = hd ** -0.5

    def loss(q, k, v):
        return jnp.sum(jnp.square(jka.fused_attention(q, k, v, scale, mask, interpret=True)))

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    got = _attention_grads(q, k, v, scale, mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4)


def test_mlp_tail_gradients_match_jax(rng):
    """K2 under autograd (``MlpTail``: the recompute of the plain tail)
    against ``jax.grad`` through ``fused_mlp_tail(interpret=True)`` at
    ``tests/test_fused_block.py``'s test_mlp_tail_gradients case (96 -> 192,
    128 rows), x and every weight of the tail, atol and rtol 1e-3."""
    jspec, params, block = _pair(dict(dim=96, dim_out=192, num_heads=1, kernel_q=(3, 3, 3),
                                      kernel_kv=(3, 3, 3), stride_q=(1, 2, 2),
                                      stride_kv=(1, 2, 2)), seed=4)
    x = jnp.asarray(rng.standard_normal((1, 128, 96)), jnp.float32)

    def loss(x, p):
        return jnp.sum(jnp.square(jkb.fused_mlp_tail(x, p, jspec, interpret=True)))

    gx, gp = jax.grad(loss, argnums=(0, 1))(x, params)
    xt = torch.from_numpy(np.asarray(x)).requires_grad_()
    out = kb.fused_mlp_tail(xt, *block._tail_weights(attn_proj=False)[2:])
    assert type(out.grad_fn).__name__ == "MlpTailBackward"
    out.square().sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-3, rtol=1e-3)
    _check_param_grads(block, gp, atol=1e-3, rtol=1e-3)


def test_fused_block_gradients_match_jax(rng):
    """B3 under autograd (``FusedBlock``: the recompute of the plain block)
    with its pooled K/V from phase 1, against ``jax.grad`` through
    ``fused_block(interpret=True)`` at ``tests/test_fused_block.py``'s
    test_fused_block_gradients case: x and every parameter, atol and rtol
    1e-3."""
    thw = (1, 16, 16)
    jspec, params, block = _pair(dict(dim=96, dim_out=96, num_heads=1, kernel_kv=(3, 3, 3),
                                      stride_kv=(1, 4, 4)), seed=2)
    x = jnp.asarray(rng.standard_normal((1, 256, 96)), jnp.float32)

    def loss(x, p):
        kk, vv = jmvit._pooled_kv(p, jspec, x, thw)
        return jnp.sum(jnp.square(jkb.fused_block(x, kk, vv, p, jspec, interpret=True)))

    gx, gp = jax.grad(loss, argnums=(0, 1))(x, params)
    assert tmvit.block_route(block.spec, None, thw) == "block"
    xt = torch.from_numpy(np.asarray(x)).requires_grad_()
    out, _ = block.forward_block(xt, thw)
    assert type(out.grad_fn).__name__ == "FusedBlockBackward"
    out.square().sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-3, rtol=1e-3)
    _check_param_grads(block, gp, atol=1e-3, rtol=1e-3)


def test_decoder_block_under_train_decoder_matches_jax(rng, monkeypatch):
    """A decoder block in training with TRAIN_DECODER on
    (``DecoderBlockTrain``: B5's forward, the composite recompute backward)
    against ``mvit._decoder_block_ad`` with the decoder and skip kernels
    interpreted, at ``tests/test_fused_block.py``'s DEC_CASES[2] (192 -> 96,
    2 heads, grid (4, 8, 16), stride (2, 1, 1)): the loss within 1e-5
    relative, x and every parameter's gradient within 2e-3."""
    dim, dim_out, heads, thw, sq, skv = 192, 96, 2, (4, 8, 16), (2, 1, 1), (1, 4, 4)
    jspec, params, block = _pair(dict(dim=dim, dim_out=dim_out, num_heads=heads,
                                      kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3), stride_q=sq,
                                      stride_kv=skv, upsample_q=True), seed=8)
    l = thw[0] * thw[1] * thw[2]
    x = jnp.asarray(rng.standard_normal((1, l, dim)) * 0.5, jnp.float32)
    thw_f = jmvit._static_upsample_out(thw, jspec.kernel_q, jspec.stride_q, jspec.padding_q,
                                       jspec.output_padding_q)
    for mod, name in ((jkb, "fused_decoder_block"), (jkup, "t2_upsample_padded"),
                      (jkup, "hw2_upsample")):
        _interpret(monkeypatch, mod, name)

    def loss(x, p):
        return jnp.sum(jnp.square(jmvit._decoder_block_ad(x, p, jspec, thw, tuple(thw_f))))

    l_j, (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1))(x, params)
    ka.set_train_decoder(True)
    block.train()
    assert tmvit.train_route(block.spec, None, thw) == "decoder_block"
    xt = torch.from_numpy(np.asarray(x)).requires_grad_()
    out, out_thw = block(xt, thw)
    assert out_thw == tuple(thw_f)
    assert type(out.grad_fn).__name__ == "DecoderBlockTrainBackward"
    l_t = out.square().sum()
    l_t.backward()
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=2e-3, rtol=2e-3)
    _check_param_grads(block, gp, atol=2e-3, rtol=2e-3)


# --- a training step under each combination --------------------------------------

CROP = 64
BATCH = 2


def _configs():
    jcfg = graft._small_cfg(BATCH)
    cfg = presets.small_cfg(BATCH)
    for c in (jcfg, cfg):
        c.DATA.TRAIN_CROP_SIZE = c.DATA.TEST_CROP_SIZE = CROP
        c.MVIT.DROPPATH_RATE = 0.0
    return jcfg, cfg


def _batch(rng):
    hw = CROP // 4
    hm = rng.uniform(0.0, 1.0, (BATCH, 8, hw, hw)).astype(np.float32)
    return {"video": rng.standard_normal((BATCH, 8, CROP, CROP, 3)).astype(np.float32),
            "audio": rng.standard_normal((BATCH, 8, 32, 32, 1)).astype(np.float32),
            "labels_hm": hm / hm.sum(axis=(-2, -1), keepdims=True)}


def _count_decoder_calls(monkeypatch) -> dict:
    """Counts the port's DecoderBlockTrain applications and the JAX decoder
    kernel's calls (at trace time)."""
    seen = {"port": 0, "jax": 0}
    apply, jdec = tmvit.DecoderBlockTrain.apply, jkb.fused_decoder_block

    def port(*a):
        seen["port"] += 1
        return apply(*a)

    def jax_dec(*a, **k):
        seen["jax"] += 1
        return jdec(*a, **k)

    monkeypatch.setattr(tmvit.DecoderBlockTrain, "apply", port)
    monkeypatch.setattr(jkb, "fused_decoder_block", jax_dec)
    return seen


@pytest.mark.parametrize("attn,decoder", [(True, False), (True, True), (False, False),
                                          (False, True)],
                         ids=["train_attn", "train_attn+train_decoder", "train_attn_off",
                              "train_attn_off+train_decoder"])
def test_train_step_under_switches_matches_jax(rng, monkeypatch, attn, decoder):
    """One ``small_cfg`` step at crop 64 (kldiv+egonce, DROPPATH_RATE 0)
    with TRAIN_ATTN and TRAIN_DECODER set alike in both packages, the JAX
    kernels enabled and interpreted (K1 under TRAIN_ATTN, the training
    tail, B5 and its skip kernels), against ``make_train_step``: the losses
    and lr within 1e-5 relative, the pre-clip gradient norm within 1e-3,
    each weight within 2·BASE_LR. Under TRAIN_DECODER JAX runs B5 at d3 and
    d4 and the port at d1-d4."""
    jcfg, cfg = _configs()
    jspec = jcsts.build_spec(jcfg)
    jstate, tx = jstep.create_train_state(jcfg, jspec, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    batch = _batch(rng)
    seen = _count_decoder_calls(monkeypatch)
    for mod, name in ((jka, "fused_attention"), (jkb, "fused_mlp_tail_train"),
                      (jkb, "fused_decoder_block"), (jkup, "t2_upsample_padded"),
                      (jkup, "hw2_upsample")):
        _interpret(monkeypatch, mod, name)
    jka.set_enabled(True)
    jka.set_train_attention(attn)
    jka.set_train_decoder(decoder)
    jstate, jstats, _ = jstep.make_train_step(jcfg, jspec, tx, 10)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    jka.set_enabled(None)

    ka.set_train_attention(attn)
    ka.set_train_decoder(decoder)
    state = tstep.create_train_state(cfg, build_spec(cfg), state_dict=state_dict_from_jax(params),
                                     device="cpu")
    stats, _ = tstep.make_train_step(cfg, build_spec(cfg), 10)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    assert seen == ({"port": 4, "jax": 2} if decoder else {"port": 0, "jax": 0}), seen
    for name in ("loss", "kldiv_loss", "egonce_loss", "lr"):
        assert float(stats[name]) == pytest.approx(float(jstats[name]), rel=1e-5), name
    assert float(stats["grad_norm"]) == pytest.approx(float(jstats["grad_norm"]), rel=1e-3)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=2 * cfg.SOLVER.BASE_LR, rtol=0, err_msg=n)


@pytest.mark.parametrize("how", ["grad_cache", "act_checkpoint"])
def test_train_decoder_in_both_passes(rng, monkeypatch, how):
    """GradCache (``accum_steps=2``: a pass without grad, then the replay)
    and MODEL.ACT_CHECKPOINT under TRAIN_DECODER: B5's route in every pass
    (4 decoder blocks a micro-batch forward), and the step's stats and
    gradients equal those of the same step with the switch off within 1e-5
    relative (the port against itself: the route changes, the result does
    not)."""
    _, cfg = _configs()
    cfg.MODEL.ACT_CHECKPOINT = how == "act_checkpoint"
    accum = 2 if how == "grad_cache" else 1
    spec = build_spec(cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(rng).items()}
    seen = _count_decoder_calls(monkeypatch)
    out = {}
    for decoder in (False, True):
        ka.set_train_decoder(decoder)
        state = tstep.create_train_state(cfg, spec, torch.Generator().manual_seed(0),
                                         device="cpu")
        grads = {}
        step = state.optimizer.step

        def record(lr, grads=grads, state=state, step=step):
            grads.update({n: p.grad.clone() for n, p in state.model.named_parameters()})
            return step(lr)

        state.optimizer.step = record
        stats, _ = tstep.make_train_step(cfg, spec, 10, accum_steps=accum)(state, batch, None)
        out[decoder] = stats, grads
    # GradCache: 2 micro-batches in each of its 2 passes
    assert seen["port"] == (4 * 2 * 2 if accum == 2 else 4), seen
    (s0, g0), (s1, g1) = out[False], out[True]
    for k in ("loss", "kldiv_loss", "egonce_loss", "grad_norm"):
        assert float(s1[k]) == pytest.approx(float(s0[k]), rel=1e-5), k
    total = float(torch.sqrt(sum(g.square().sum() for g in g0.values())))
    for n, g in g0.items():
        err = float((g1[n] - g).norm())
        assert err <= 1e-5 * float(g.norm()) + 1e-6 * total, n

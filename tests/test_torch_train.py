"""The port's training step against the JAX package on the CPU, fp32: every
loss of the registry, the LR schedule, the weight-decay groups, one
optimizer update against optax, and at ``small_cfg(2)`` (drop-path 0.2,
kldiv+egonce) the loss and every parameter gradient against
``jax.value_and_grad`` of ``make_train_step``'s objective, then two whole
steps against ``make_train_step``. The stochastic-depth masks are rebuilt
from the JAX key stream and injected into the port, which cannot draw them.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from csts_tpu.models import csts as jcsts
from csts_tpu.train import losses as jlosses
from csts_tpu.train import step as jstep
from csts_tpu.train.lr_policy import get_lr_at_epoch as jax_lr
from csts_tpu.train.optimizer import construct_optimizer as jax_optimizer
from csts_tpu.train.optimizer import weight_decay_mask as jax_wd_mask
from csts_torch import presets
from csts_torch.convert.from_jax import state_dict_from_jax
from csts_torch.models.csts import CSTS, build_spec
from csts_torch.train import losses
from csts_torch.train import step as tstep
from csts_torch.train.lr_policy import get_lr_at_epoch
from csts_torch.train.optimizer import construct_optimizer, weight_decay_mask

torch.set_num_threads(2)


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _t(a):
    return torch.from_numpy(_np(a).copy())


# ----------------------------------------------------------------------------------
# losses, schedule, optimizer
# ----------------------------------------------------------------------------------


def _heatmaps(rng, shape):
    hm = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    return hm / hm.sum(axis=(2, 3), keepdims=True)


def _loss_cases():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 4, 8, 8, 1)).astype(np.float32)
    probs = np.asarray(jlosses.frame_softmax(jnp.asarray(logits)))
    hm = _heatmaps(rng, (2, 4, 8, 8))
    # a label map with a tie between two maxima, the case the weight averages
    hm_tie = hm.copy()
    hm_tie[0, 0, 1, 2] = hm_tie[0, 0, 5, 6] = 2.0
    emb_a = rng.standard_normal((6, 16)).astype(np.float32)
    emb_b = rng.standard_normal((6, 16)).astype(np.float32)
    sim = np.asarray(jlosses.sim_matrix(jnp.asarray(emb_a), jnp.asarray(emb_b)))
    x = rng.standard_normal((5, 7)).astype(np.float32)
    y_soft = rng.dirichlet(np.ones(7), 5).astype(np.float32)
    y_bin = (rng.uniform(size=(5, 7)) < 0.3).astype(np.float32)
    p = rng.uniform(0.01, 0.99, (5, 7)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (5, 7)).astype(np.float32)
    return {
        "frame_softmax": ("frame_softmax", (logits,)),
        "sim_matrix": ("sim_matrix", (emb_a, emb_b)),
        "kldiv": ("kldiv", (probs, hm)),
        "kldiv_uniform": ("kldiv", (probs,)),
        "egonce": ("egonce", (sim,)),
        "floss": ("floss", (1 / (1 + np.exp(-logits)), hm_tie)),
        "kldiv+floss": ("kldiv+floss", (logits, hm)),
        "soft_cross_entropy": ("soft_cross_entropy", (x, y_soft)),
        "bce_logit": ("bce_logit", (x, y_bin)),
        "bce": ("bce", (p, y_bin, w)),
    }


LOSS_CASES = _loss_cases()


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_matches_jax(case):
    name, args = LOSS_CASES[case]
    if name in ("frame_softmax", "sim_matrix"):
        jfn, tfn = getattr(jlosses, name), getattr(losses, name)
    else:
        jfn, tfn = jlosses.get_loss_fn(name), losses.get_loss_fn(name)
    want = np.asarray(jfn(*(jnp.asarray(a) for a in args)))
    got = tfn(*(_t(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_unknown_loss_raises_like_jax():
    with pytest.raises(NotImplementedError):
        losses.get_loss_fn("kldiv+egonce")


@pytest.mark.parametrize("policy,warmup", [("cosine", 0.0), ("cosine", 2.5),
                                           ("steps_with_relative_lrs", 0.0),
                                           ("steps_with_relative_lrs", 1.0)])
def test_lr_matches_jax(policy, warmup):
    cfg = presets.flagship_cfg()
    solver = cfg.SOLVER
    solver.LR_POLICY = policy
    solver.WARMUP_EPOCHS = warmup
    solver.WARMUP_START_LR = 1e-6
    solver.STEPS = [0, 5, 10]
    solver.LRS = [1.0, 0.1, 0.01]
    # the JAX package computes in fp32, where cos near π cancels: 1e-6·BASE_LR absolute
    for epoch in (0.0, 0.3, 1.0, 2.49, 2.5, 4.99, 5.0, 7.7, 10.0, 14.9):
        want = float(jax_lr(solver, jnp.float32(epoch)))
        assert get_lr_at_epoch(solver, epoch) == pytest.approx(
            want, rel=1e-6, abs=1e-6 * solver.BASE_LR), epoch


# ----------------------------------------------------------------------------------
# the small model: one JAX init shared by every test below
# ----------------------------------------------------------------------------------

BATCH = 2


def _cfgs():
    jcfg, tcfg = graft._small_cfg(BATCH), presets.small_cfg(BATCH)
    for c in (jcfg, tcfg):
        c.MVIT.DROPPATH_RATE = 0.2  # the flagship's, on the small model's 4 blocks
    return jcfg, tcfg


@pytest.fixture(scope="module")
def small_init():
    jcfg, _ = _cfgs()
    jspec = jcsts.build_spec(jcfg)
    params = jcsts.csts_init(jax.random.PRNGKey(0), jspec)
    rng = np.random.default_rng(4)
    batch = {
        "video": rng.standard_normal((BATCH, 8, 32, 32, 3)).astype(np.float32),
        "audio": rng.standard_normal((BATCH, 8, 32, 32, 1)).astype(np.float32),
        "labels_hm": _heatmaps(rng, (BATCH, 8, 8, 8)),
    }
    return jspec, params, batch


@pytest.fixture
def small(small_init):
    """Fresh configs (tests change them) around the shared init."""
    return (*_cfgs(), *small_init)


def _port_model(tcfg, params):
    model = CSTS(build_spec(tcfg))
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                          strict=True)
    return model.train()


def test_weight_decay_mask_matches_jax(small):
    jcfg, tcfg, _, params, _ = small
    jmask = jax_wd_mask(params, jcfg)
    # the JAX mask's leaves as arrays of each parameter's shape, under the port's names
    full = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, float(m), np.float32),
                                  jmask, params)
    want = {n: bool(v.reshape(-1)[0]) for n, v in state_dict_from_jax(full).items()}
    got = weight_decay_mask(_port_model(tcfg, params), tcfg)
    assert got == want
    assert not got["pos_embed_spatial_audio"] and not got["blocks.0.norm1.weight"]
    assert got["blocks.0.attn.qkv.weight"]


@pytest.mark.parametrize("method", ["adamw", "sgd"])
def test_optimizer_update_matches_optax(small, method):
    """One update from identical weights and gradients (clip active: the
    gradients' global norm is far above CLIP_GRAD_L2NORM)."""
    jcfg, tcfg, _, params, _ = small
    for c in (jcfg, tcfg):
        c.SOLVER.OPTIMIZING_METHOD = method
    rng = np.random.default_rng(9)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
    lr = 3e-4
    tx = jax_optimizer(params, jcfg)
    opt_state = tx.init(params)
    opt_state.hyperparams["learning_rate"] = jnp.float32(lr)
    updates, _ = tx.update(grads, opt_state, params)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      optax.apply_updates(params, updates)))
    model = _port_model(tcfg, params)
    g_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    for n, p in model.named_parameters():
        p.grad = g_sd[n].clone()
    opt = construct_optimizer(model, tcfg)
    norm = opt.step(lr)
    assert float(norm) == pytest.approx(float(optax.global_norm(grads)), rel=1e-5)
    assert float(norm) > tcfg.SOLVER.CLIP_GRAD_L2NORM
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-6, rtol=0,
                                   err_msg=n)


def test_unported_solver_options_raise(small):
    """ZeRO-1 and FSDP shard over a process group
    (tests/test_torch_parallel.py); in one process, which holds every
    shard, they are the plain optimizer. BF16_MOMENTS and gradient
    accumulation are ported (tests/test_torch_trainer.py)."""
    _, tcfg, _, params, _ = small
    model = _port_model(tcfg, params)
    for option in ("ZERO1", "FSDP"):
        setattr(tcfg.SOLVER, option, True)
        assert type(construct_optimizer(model, tcfg).opt) is torch.optim.AdamW
        setattr(tcfg.SOLVER, option, False)
    tcfg.SOLVER.BF16_MOMENTS = True
    construct_optimizer(model, tcfg)
    tstep.make_train_step(tcfg, build_spec(tcfg), steps_per_epoch=10, accum_steps=2)


# ----------------------------------------------------------------------------------
# the training objective and whole steps
# ----------------------------------------------------------------------------------


def _jax_drop_masks(jspec, key, batch):
    """The masks ``csts_apply`` draws at ``deterministic=False`` from ``key``:
    per video block, split(key, n_blocks)[i] split again into the attention
    branch's and the MLP branch's keys, bernoulli(keep) / keep per sample."""
    keys = jax.random.split(key, len(jspec.video_blocks))
    out = []
    for blk, k in zip(jspec.video_blocks, keys):
        if blk.drop_path == 0.0:
            out.append(None)
            continue
        keep = 1.0 - blk.drop_path
        pair = tuple(
            _t(jax.random.bernoulli(kk, keep, (batch, 1, 1)).astype(jnp.float32) / keep
               ).reshape(batch)
            for kk in jax.random.split(k))
        out.append(pair)
    return out


def _jax_loss_fn(jcfg, jspec):
    """``make_train_step``'s loss_fn for kldiv+egonce."""
    alpha = jcfg.MODEL.LOSS_ALPHA

    def loss_fn(params, batch, rng):
        logits, v, a = jcsts.csts_apply(params, jspec, batch["video"], batch["audio"],
                                        deterministic=False, rng=rng, return_embed=True)
        preds = jlosses.frame_softmax(logits, temperature=2.0)
        kl = jlosses.kldiv_loss(preds, batch["labels_hm"])
        nce = jlosses.egonce_loss(jlosses.sim_matrix(v, a))
        return kl + alpha * nce, (kl, nce)

    return loss_fn


@pytest.fixture(scope="module")
def jax_runs(small_init):
    """The JAX side, compiled once: value_and_grad of the objective at key A,
    and two make_train_step steps at keys A and B."""
    jspec, params, batch = small_init
    jcfg, _ = _cfgs()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key_a, key_b = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    (loss, (kl, nce)), grads = jax.jit(jax.value_and_grad(_jax_loss_fn(jcfg, jspec),
                                                          has_aux=True))(params, jbatch, key_a)
    state, tx = jstep.create_train_state(jcfg, jspec, jax.random.PRNGKey(0))
    train_step = jstep.make_train_step(jcfg, jspec, tx, steps_per_epoch=10)
    stats = []
    for key in (key_a, key_b):
        state, st, _ = train_step(state, jbatch, key)
        stats.append({k: float(v) for k, v in st.items()})
    return {
        "loss": float(loss), "kl": float(kl), "nce": float(nce),
        "grads": state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads)),
        "stats": stats,
        "params": state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params)),
        "keys": (key_a, key_b),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_drop_masks_drop_something(small, jax_runs):
    """The parity below exercises stochastic depth: among the rebuilt masks
    some sample of some branch is dropped and some kept."""
    _, _, jspec, _, _ = small
    masks = [m for pair in _jax_drop_masks(jspec, jax_runs["keys"][0], BATCH) if pair
             for m in pair]
    vals = torch.cat(masks)
    assert bool((vals == 0).any()) and bool((vals > 1).any())


def test_loss_and_gradients_match_jax(small, jax_runs):
    """The objective and every parameter's gradient against jax.value_and_grad."""
    _, tcfg, jspec, params, batch = small
    model = _port_model(tcfg, params)
    drop = _jax_drop_masks(jspec, jax_runs["keys"][0], BATCH)
    loss, stats, _ = tstep.forward_loss(tcfg, model, _torch_batch(batch), drop)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(jax_runs["loss"], rel=1e-5)
    assert float(stats["kldiv_loss"]) == pytest.approx(jax_runs["kl"], rel=1e-5)
    assert float(stats["egonce_loss"]) == pytest.approx(jax_runs["nce"], rel=1e-5)
    want = jax_runs["grads"]
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), atol=2e-4, rtol=2e-3,
                                   err_msg=n)


def test_two_steps_match_make_train_step(small, jax_runs):
    """Two whole steps (clip, AdamW, the cosine LR) against make_train_step:
    the first step's stats to 1e-5, the second's to 1e-4, each parameter
    within 2·BASE_LR per step (a near-zero gradient whose sign flips moves
    one Adam step by that much). Adam's first step scales each gradient to
    g / (|g| + 1e-8), so weights whose gradients are near 1e-8, where the two
    packages' fp32 sums differ relatively most, move by up to 0.1·BASE_LR
    apart (measured ~1e-5 at most), which moves the second step's gradient
    norm by ~1.5e-5 relative."""
    _, tcfg, jspec, params, batch = small
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    state = tstep.create_train_state(tcfg, build_spec(tcfg), state_dict=sd, device="cpu")
    train_step = tstep.make_train_step(tcfg, build_spec(tcfg), steps_per_epoch=10)
    tb = _torch_batch(batch)
    for key, want, rel in zip(jax_runs["keys"], jax_runs["stats"], (1e-5, 1e-4)):
        stats, preds = train_step(state, tb, None, drop=_jax_drop_masks(jspec, key, BATCH))
        assert tuple(preds.shape) == (BATCH, 8, 8, 8, 1)
        for name, value in want.items():
            assert float(stats[name]) == pytest.approx(value, rel=rel), name
    assert state.step == 2
    bar = 2 * 2 * tcfg.SOLVER.BASE_LR
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jax_runs["params"][n].numpy(), atol=bar,
                                   rtol=0, err_msg=n)


def test_ema_and_eval_step(small):
    """EMA in fp32 after a step (decay 0.9: 0.9·w0 + 0.1·w1), and the eval
    step leaves the model in training mode."""
    _, tcfg, _, params, batch = small
    tcfg.SOLVER.EMA_DECAY = 0.9
    spec = build_spec(tcfg)
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    state = tstep.create_train_state(tcfg, spec, state_dict=sd, device="cpu")
    tstep.make_train_step(tcfg, spec, steps_per_epoch=10)(
        state, _torch_batch(batch), torch.Generator().manual_seed(0))
    for n, p in state.model.named_parameters():
        torch.testing.assert_close(state.ema[n], 0.9 * sd[n] + 0.1 * p.detach(),
                                   rtol=0, atol=1e-6)
    heat = tstep.make_eval_step(tcfg, spec)(state.model, _torch_batch(batch))
    assert tuple(heat.shape) == (BATCH, 8, 8, 8, 1) and state.model.training
    np.testing.assert_allclose(heat.sum(dim=(2, 3)).numpy(), 1.0, atol=1e-5)
    with pytest.raises(RuntimeError):
        tstep.check_nan_loss(float("nan"), 3)

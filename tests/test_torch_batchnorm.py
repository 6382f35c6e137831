"""The BN family of the port (``csts_torch/models/batchnorm.py``) against the
JAX package's (``csts_tpu/models/batchnorm.py``) on the CPU, fp32: train and
eval BatchNorm with its running statistics, SubBN's splits and aggregation,
the two checkpoint-layout converters, precise BN; and synchronised BN on two
gloo ranks (``all_reduce``) against one process on the global batch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from csts_tpu.models import batchnorm as jbn
from csts_torch.models import batchnorm as tbn
from test_torch_multiproc import WORLD, run_ranks, sync_bn_worker

torch.set_num_threads(2)

TOL = 1e-5


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, atol=tol, rtol=0)


def _inputs(seed: int, shape=(4, 2, 5, 5, 6)):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.standard_normal(c).astype(np.float32)}
    state = {"mean": rng.standard_normal(c).astype(np.float32) * 0.1,
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return x, params, state


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("momentum", [0.1, 1.0])
def test_batch_norm_matches_jax(training, momentum):
    x, params, state = _inputs(0)
    got, got_state = tbn.batch_norm(_t(params), _t(state), torch.from_numpy(x),
                                    training=training, momentum=momentum)
    want, want_state = jbn.batch_norm(_j(params), _j(state), jnp.asarray(x),
                                      training=training, momentum=momentum)
    _close(got, want)
    _close(got_state, want_state)


def test_bn_init_matches_jax():
    _close(tbn.bn_init(5), jbn.bn_init(5), tol=0)
    _close(tbn.bn_state_init(5), jbn.bn_state_init(5), tol=0)


@pytest.mark.parametrize("momentum", [0.1, 1.0])
def test_sub_batch_norm_matches_jax(momentum):
    x, params, _ = _inputs(1, (6, 2, 3, 3, 4))
    tsub, jsub = tbn.SubBatchNorm(num_splits=3, dim=4), jbn.SubBatchNorm(num_splits=3, dim=4)
    tp, ts = tsub.init()
    jp, js = jsub.init()
    _close(ts, js, tol=0)
    tp, jp = _t(params), _j(params)
    got, ts = tsub.apply(tp, ts, torch.from_numpy(x), training=True, momentum=momentum)
    want, js = jsub.apply(jp, js, jnp.asarray(x), training=True, momentum=momentum)
    _close(got, want)
    _close(ts, js)
    ts, js = tsub.aggregate_stats(ts), jsub.aggregate_stats(js)
    _close(ts, js)
    if momentum == 1.0:
        # the aggregated mean is the whole batch's
        np.testing.assert_allclose(ts["global"]["mean"].numpy(), x.mean(axis=(0, 1, 2, 3)),
                                   atol=TOL)
    got, _ = tsub.apply(tp, ts, torch.from_numpy(x), training=False)
    want, _ = jsub.apply(jp, js, jnp.asarray(x), training=False)
    _close(got, want)


def test_state_converters_match_jax():
    rng = np.random.default_rng(2)
    sub = jbn.SubBatchNorm(num_splits=3, dim=4)
    _, js = sub.init()
    x = jnp.asarray(rng.standard_normal((6, 2, 3, 3, 4)).astype(np.float32))
    _, js = sub.apply(_j({"scale": np.ones(4, np.float32), "bias": np.zeros(4, np.float32)}),
                      js, x, training=True, momentum=1.0)
    js = sub.aggregate_stats(js)
    ts = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), js)
    tree_j = {"s1": {"bn": js, "w": jnp.ones((2, 2))}, "blocks": [{"bn": js}, {"w": 3}]}
    tree_t = {"s1": {"bn": ts, "w": torch.ones(2, 2)}, "blocks": [{"bn": ts}, {"w": 3}]}
    saved_t = tbn.sub_to_normal_bn_state(tree_t)
    _close(saved_t, jbn.sub_to_normal_bn_state(tree_j))
    assert saved_t["s1"]["w"] is tree_t["s1"]["w"]
    # a normal-BN checkpoint into the SubBN model, and a partial one
    flat = {"mean": rng.standard_normal(4).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, 4).astype(np.float32)}
    _, model_j = sub.init()
    model_t = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), model_j)
    for ckpt in ({"s1": {"bn": flat}, "extra": 7}, {"other": 1}, None):
        got = tbn.normal_to_sub_bn_state(
            jax.tree_util.tree_map(
                lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a, ckpt),
            {"s1": {"bn": model_t}, "extra": 0})
        want = jbn.normal_to_sub_bn_state(ckpt, {"s1": {"bn": model_j}, "extra": 0})
        _close(got, want, tol=0)
    lists_t = tbn.normal_to_sub_bn_state([_t(flat)], [model_t, model_t])
    lists_j = jbn.normal_to_sub_bn_state([flat], [model_j, model_j])
    _close(lists_t, lists_j, tol=0)


def test_update_precise_stats_matches_jax():
    x, params, state = _inputs(3)
    batches = [x * (i + 1) + i for i in range(4)]

    def t_apply(p, s, batch):
        return tbn.batch_norm(p, s, torch.from_numpy(batch), training=True, momentum=1.0)

    def j_apply(p, s, batch):
        return jbn.batch_norm(p, s, jnp.asarray(batch), training=True, momentum=1.0)

    got = tbn.update_precise_stats(t_apply, _t(params), _t(state), batches, num_iters=3)
    want = jbn.update_precise_stats(j_apply, _j(params), _j(state), batches, num_iters=3)
    _close(got, want, tol=1e-4)


def test_sync_bn_two_ranks_equals_global_batch(tmp_path):
    """Each rank normalises its stripe with the statistics all-reduced over
    the group: the outputs, the new running statistics and the gradients
    equal one process's on the global batch (and the JAX function's)."""
    x, params, _ = _inputs(4, (2 * WORLD, 2, 4, 4, 8))
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, x=x, w=w, **params)
    out = str(tmp_path / "rank")
    run_ranks(sync_bn_worker, inputs, out)

    xt = torch.from_numpy(x).requires_grad_()
    y, state = tbn.batch_norm(_t(params), tbn.bn_state_init(8), xt, training=True)
    (y * torch.from_numpy(w)).sum().backward()
    want_j, _ = jbn.batch_norm(_j(params), jbn.bn_state_init(8), jnp.asarray(x), training=True)
    n = x.shape[0] // WORLD
    for rank in range(WORLD):
        got = np.load(f"{out}-{rank}.npz")
        rows = slice(rank * n, (rank + 1) * n)
        np.testing.assert_allclose(got["y"], y.detach().numpy()[rows], atol=TOL, rtol=0)
        np.testing.assert_allclose(got["y"], np.asarray(want_j)[rows], atol=TOL, rtol=0)
        np.testing.assert_allclose(got["mean"], state["mean"].detach().numpy(), atol=TOL)
        np.testing.assert_allclose(got["var"], state["var"].detach().numpy(), atol=TOL)
        np.testing.assert_allclose(got["grad"], xt.grad.numpy()[rows], atol=TOL, rtol=0)

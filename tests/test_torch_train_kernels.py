"""The port's training kernels' autograd Functions against the JAX package on
the CPU, fp32: B7 (the training MLP tail: forward and its hand-written
backward) against ``fused_mlp_tail_train`` in interpret mode and ``jax.vjp``
of it; B8 (the attention backward) against ``_flash_bwd_impl`` in interpret
mode, and the masked sites' backward against JAX's composite ``_bwd``; K3's
adjoint against ``jax.vjp`` of the JAX package's trilinear resize at T×2.

On the CPU each Function's forward runs its kernel's plain twin, and its
backward is the code the card runs (B7), the plain twin of B8, or K3's
adjoint; the CUDA kernels are held against the same plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from csts_tpu import ops as jops
from csts_tpu.kernels import attention as jka
from csts_tpu.kernels import block as jkb
from csts_tpu.models import mvit as jmvit
from csts_torch.convert.from_jax import _block
from csts_torch.kernels import attention as ka
from csts_torch.kernels import block as kb
from csts_torch.kernels import upsample as kup

torch.set_num_threads(2)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


def _tail_params(spec, seed):
    """JAX block params with non-trivial LN2 and biases."""
    params = jmvit.multiscale_block_init(jax.random.PRNGKey(seed), spec)
    rng = np.random.default_rng(seed)
    params["norm2"]["scale"] = jnp.asarray(1 + 0.1 * rng.standard_normal(spec.dim), jnp.float32)
    params["norm2"]["bias"] = jnp.asarray(0.1 * rng.standard_normal(spec.dim), jnp.float32)
    for lin in (params["mlp"]["fc1"], params["mlp"]["fc2"], params.get("proj")):
        if lin is not None:
            lin["b"] = jnp.asarray(0.1 * rng.standard_normal(lin["b"].shape), jnp.float32)
    return params


TAIL_NAMES = ("norm2.weight", "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias",
              "mlp.fc2.weight", "mlp.fc2.bias", "proj.weight", "proj.bias")


@pytest.mark.parametrize("dim,dim_out,upsample", [(96, 96, False), (96, 192, False),
                                                  (384, 192, True)])
def test_mlp_tail_train_matches_pallas(dim, dim_out, upsample):
    """B7: out against the Pallas kernel, then the gradients of x and of every
    tail weight for one output cotangent against jax.vjp of the kernel's
    custom VJP (``_tail_train_bwd``), with one sample's MLP branch dropped."""
    spec = jmvit.AttentionSpec(
        dim=dim, dim_out=dim_out, num_heads=1,
        kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3), stride_q=(1, 2, 2), stride_kv=(1, 2, 2),
        upsample_q=upsample, fused=True, drop_path=0.1,
    )
    params = _tail_params(spec, 5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 256, dim)).astype(np.float32)
    g = rng.standard_normal((3, 256, dim_out)).astype(np.float32)
    dp = np.asarray([0.0, 1 / 0.9, 1 / 0.9], np.float32)

    want, vjp = jax.vjp(
        lambda x_, p_: jkb.fused_mlp_tail_train(x_, p_, spec, jnp.asarray(dp), interpret=True),
        jnp.asarray(x), params)
    gx_want, gp_want = vjp(jnp.asarray(g))
    sd_want = {}
    _block(sd_want, "blk", jax.tree_util.tree_map(np.asarray, gp_want), upsample=upsample)

    sd = {}
    _block(sd, "blk", jax.tree_util.tree_map(np.asarray, params), upsample=upsample)
    names = [n for n in TAIL_NAMES if f"blk.{n}" in sd]
    leaves = {n: _t(sd[f"blk.{n}"], grad=True) for n in names}
    xt = _t(x, grad=True)
    tail = [leaves.get(n) for n in TAIL_NAMES]
    out = kb.mlp_tail_train(xt, *tail, torch.from_numpy(dp))
    assert tuple(out.shape) == (3, 256, dim_out)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)

    got = torch.autograd.grad(out, [xt] + [leaves[n] for n in names], torch.from_numpy(g))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(gx_want), atol=2e-4, rtol=1e-3)
    for n, gt in zip(names, got[1:]):
        np.testing.assert_allclose(gt.numpy(), sd_want[f"blk.{n}"], atol=2e-4, rtol=1e-3,
                                   err_msg=n)


@pytest.mark.parametrize("b,n,lq,lk,hd", [
    (1, 2, 128, 250, 96),   # padding in both axes (hd 96 -> 128, Lk 250 -> 256)
    (2, 4, 64, 64, 192),    # head dim 192 (d2)
    (2, 4, 100, 8, 96),     # Lk 8 (the temporal fusion), ragged Lq
])
def test_attention_bwd_matches_pallas(b, n, lq, lk, hd):
    """B8: dq, dk, dv of the port's attention Function against the Pallas
    flash backward in interpret mode, from the same q, k, v and g."""
    rng = np.random.default_rng(lq + lk)
    q, k, v = (rng.standard_normal((b, n, m, hd)).astype(np.float32) for m in (lq, lk, lk))
    g = rng.standard_normal((b, n, lq, hd)).astype(np.float32)
    scale = hd ** -0.5
    out = jka._fused_attention_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                                        scale, True)
    want = jka._flash_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out,
                               jnp.asarray(g), scale, True)
    qt, kt, vt = (_t(a, grad=True) for a in (q, k, v))
    got = torch.autograd.grad(ka.attention_train(qt, kt, vt, scale), (qt, kt, vt),
                              torch.from_numpy(g))
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4, rtol=0, err_msg=name)


def test_masked_attention_bwd_matches_jax_composite():
    """The spatial fusion's masked backward against JAX's ``_bwd`` composite
    (jax.vjp of the kernel with a mask takes it); the mask gets no gradient."""
    b, n, l, hd = 1, 2, 260, 96
    rng = np.random.default_rng(11)
    q, k, v, g = (rng.standard_normal((b, n, l, hd)).astype(np.float32) for _ in range(4))
    mask = jmvit.build_inframe_mask((4, 8, 8), 4)
    scale = hd ** -0.5
    _, vjp = jax.vjp(lambda q_, k_, v_: jka.fused_attention(q_, k_, v_, scale, jnp.asarray(mask),
                                                            interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    qt, kt, vt = (_t(a, grad=True) for a in (q, k, v))
    mt = torch.from_numpy(mask)
    got = torch.autograd.grad(ka.attention_train(qt, kt, vt, scale, mt), (qt, kt, vt),
                              torch.from_numpy(g))
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4, rtol=0, err_msg=name)
    assert not mt.requires_grad


@pytest.mark.parametrize("b,thw,c", [(2, (4, 8, 8), 24), (1, (1, 4, 8), 3), (2, (3, 5, 7), 16)])
def test_t2_upsample_adjoint_matches_jax_vjp(b, thw, c):
    """K3's backward against jax.vjp of the JAX package's trilinear resize at
    T×2 (the XLA gradient JAX training takes)."""
    t, h, w = thw
    rng = np.random.default_rng(t * h + c)
    x = rng.standard_normal((b, t * h * w, c)).astype(np.float32)
    g = rng.standard_normal((b, 2 * t * h * w, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jops.trilinear_resize(a, (2 * t, h, w)),
                     jnp.asarray(x.reshape(b, t, h, w, c)))
    (want,) = vjp(jnp.asarray(g.reshape(b, 2 * t, h, w, c)))
    xt = _t(x, grad=True)
    (got,) = torch.autograd.grad(kup.t2_upsample_train(xt, thw), xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(x.shape), atol=1e-6, rtol=0)


def test_train_functions_count_no_launches_on_the_cpu():
    """On the CPU the Functions run the plain twins: no launch counter moves."""
    counters = (ka.fused_attention, ka.fused_attention_bwd, kb.fused_mlp_tail_train,
                kup.t2_upsample)
    before = [f.launches for f in counters]
    x = torch.randn(1, 2, 16, 64, requires_grad=True)
    ka.attention_train(x, x, x, 0.125).sum().backward()
    y = torch.randn(1, 2 * 4 * 4, 8, requires_grad=True)
    kup.t2_upsample_train(y, (2, 4, 4)).sum().backward()
    w = [torch.randn(16), torch.randn(16), torch.randn(64, 16), torch.randn(64),
         torch.randn(16, 64), torch.randn(16)]
    z = torch.randn(2, 8, 16, requires_grad=True)
    kb.mlp_tail_train(z, *w, None, None, torch.ones(2)).sum().backward()
    assert [f.launches for f in counters] == before
    assert x.grad is not None and y.grad is not None and z.grad is not None

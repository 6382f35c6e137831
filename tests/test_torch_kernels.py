"""The port's kernels (K1 attention, K2 MLP tail, K3 T×2 upsample) against the
JAX package's Pallas kernels, run as the JAX suite runs them on the CPU
(interpret mode). Here, on the CPU, each wrapper runs its plain PyTorch
version; the CUDA kernels are held against these same plain versions on the
card by ``chip_smoke.py``. All comparisons in fp32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from csts_tpu.kernels import attention as jka
from csts_tpu.kernels import block as jkb
from csts_tpu.kernels import upsample as jkup
from csts_tpu.models import mvit as jmvit
from csts_torch.convert.from_jax import _block
from csts_torch.kernels import attention as ka
from csts_torch.kernels import block as kb
from csts_torch.kernels import upsample as kup
from csts_torch.models import mvit as tmvit

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(
    "b,n,lq,lk,hd,masked",
    [
        (1, 2, 256, 64, 96, False),     # decoder-style Lk=64
        (1, 1, 512, 256, 96, False),    # stem-stage Lk=256
        (1, 1, 128, 1024, 96, False),   # Q-pool Lk=1024
        (1, 4, 128, 64, 192, False),    # d2 head dim 192
        (1, 8, 8, 8, 96, False),        # temporal fusion Lq=Lk=8
        (1, 2, 260, 260, 96, True),     # spatial fusion, in-frame mask
    ],
)
def test_attention_matches_pallas(b, n, lq, lk, hd, masked):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, n, lq, hd)).astype(np.float32)
    k = rng.standard_normal((b, n, lk, hd)).astype(np.float32)
    v = rng.standard_normal((b, n, lk, hd)).astype(np.float32)
    mask = jmvit.build_inframe_mask((4, 8, 8), 4) if masked else None
    scale = hd ** -0.5
    want = jka.fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
        None if mask is None else jnp.asarray(mask), interpret=True)
    got = ka.fused_attention(_t(q), _t(k), _t(v), scale, None if mask is None else _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_port_mask_equals_jax_mask():
    np.testing.assert_array_equal(
        tmvit.build_inframe_mask((4, 8, 8), 4), jmvit.build_inframe_mask((4, 8, 8), 4))


@pytest.mark.parametrize(
    "dim,dim_out,heads,upsample",
    [(96, 96, 1, False), (96, 192, 1, False), (384, 384, 4, False), (384, 192, 4, True)],
)
def test_mlp_tail_matches_pallas(dim, dim_out, heads, upsample):
    spec = jmvit.AttentionSpec(
        dim=dim, dim_out=dim_out, num_heads=heads,
        kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3), stride_q=(1, 2, 2), stride_kv=(1, 2, 2),
        upsample_q=upsample, fused=True,
    )
    params = jmvit.multiscale_block_init(jax.random.PRNGKey(3), spec)
    # non-trivial LN2 and biases, so every term of the tail is exercised
    rng = np.random.default_rng(1)
    params["norm2"]["scale"] = jnp.asarray(1 + 0.1 * rng.standard_normal(dim), jnp.float32)
    params["norm2"]["bias"] = jnp.asarray(0.1 * rng.standard_normal(dim), jnp.float32)
    for lin in (params["mlp"]["fc1"], params["mlp"]["fc2"], params.get("proj")):
        if lin is not None:
            lin["b"] = jnp.asarray(0.1 * rng.standard_normal(lin["b"].shape), jnp.float32)
    x = rng.standard_normal((2, 256, dim)).astype(np.float32)
    want = jkb.fused_mlp_tail(jnp.asarray(x), params, spec, interpret=True)

    sd = {}
    _block(sd, "blk", jax.tree_util.tree_map(np.asarray, params), upsample=upsample)
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    has_proj = dim != dim_out
    got = kb.fused_mlp_tail(
        _t(x), sd["blk.norm2.weight"], sd["blk.norm2.bias"],
        sd["blk.mlp.fc1.weight"], sd["blk.mlp.fc1.bias"],
        sd["blk.mlp.fc2.weight"], sd["blk.mlp.fc2.bias"],
        sd["blk.proj.weight"] if has_proj else None, sd["blk.proj.bias"] if has_proj else None,
    )
    assert tuple(got.shape) == (2, 256, dim_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("t_c,h,w,c", [(4, 8, 8, 24), (2, 4, 8, 7), (4, 16, 16, 192), (1, 4, 8, 3)])
def test_t2_upsample_matches_pallas(t_c, h, w, c):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, t_c * h * w, c)).astype(np.float32)
    want = jkup.t2_upsample_padded(jnp.asarray(x), (t_c, h, w), interpret=True)[..., :c]
    got = kup.t2_upsample(_t(x), (t_c, h, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_cpu_wrappers_take_the_plain_path_without_counting():
    """On a CPU tensor each wrapper is its plain version; the launch counters
    only move on the card."""
    before = (ka.fused_attention.launches, kb.fused_mlp_tail.launches, kup.t2_upsample.launches)
    rng = np.random.default_rng(3)
    q, k, v = (_t(rng.standard_normal((1, 1, 16, 16)).astype(np.float32)) for _ in range(3))
    assert torch.equal(ka.fused_attention(q, k, v, 0.25), ka.fused_attention_plain(q, k, v, 0.25))
    x = _t(rng.standard_normal((1, 2 * 16, 16)).astype(np.float32))
    assert torch.equal(kup.t2_upsample(x, (2, 4, 4)), kup.t2_upsample_plain(x, (2, 4, 4)))
    after = (ka.fused_attention.launches, kb.fused_mlp_tail.launches, kup.t2_upsample.launches)
    assert before == after


def test_wrappers_refuse_other_devices():
    """No silent route: a tensor that is neither on the CPU nor on CUDA raises."""
    q = torch.empty((1, 1, 16, 16), device="meta")
    with pytest.raises(ValueError):
        ka.fused_attention(q, q, q, 0.25)
    with pytest.raises(ValueError):
        kup.t2_upsample(torch.empty((1, 32, 16), device="meta"), (2, 4, 4))
    x = torch.empty((1, 8, 16), device="meta")
    w = torch.empty((16,), device="meta")
    with pytest.raises(ValueError):
        kb.fused_mlp_tail(x, w, w, torch.empty((64, 16), device="meta"),
                          torch.empty((64,), device="meta"),
                          torch.empty((16, 64), device="meta"), w)

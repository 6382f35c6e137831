"""The PyTorch port's ops against the JAX package's on the CPU, fp32, ≤1e-5.

Inputs come from numpy with a seed and go through both packages; weights are
in each package's own layout (JAX DHWIO, torch OIDHW) and converted with the
same transposes the checkpoint converters use.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from csts_tpu import ops as jops
from csts_torch import ops as tops

torch.set_num_threads(2)

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)


def _oidhw(w):
    """JAX (kT, kH, kW, I, O) -> torch (O, I, kT, kH, kW)."""
    return w.transpose(4, 3, 0, 1, 2)


@pytest.mark.parametrize(
    "shape,cin,cout,kernel,stride,padding",
    [
        ((2, 8, 32, 32), 3, 16, (3, 7, 7), (2, 4, 4), (1, 3, 3)),  # patch embed
        ((2, 4, 8, 8), 24, 24, (1, 8, 8), (1, 1, 1), (0, 0, 0)),  # fusion pools
        ((1, 4, 6, 6), 8, 1, (1, 1, 1), (1, 1, 1), (0, 0, 0)),  # classifier
    ],
)
def test_conv3d(shape, cin, cout, kernel, stride, padding):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((*shape, cin)).astype(np.float32)
    # kaiming scale, so outputs are O(1) whatever the fan-in and the 1e-5 bar
    # measures the algorithm, not the summation order of a large sum
    fan_in = cin * int(np.prod(kernel))
    w = (rng.standard_normal((*kernel, cin, cout)) / np.sqrt(fan_in)).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    want = jops.conv3d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), stride, padding)
    got = tops.conv3d(_t(x), _t(_oidhw(w)), _t(b), stride, padding)
    _close(got, want)


@pytest.mark.parametrize(
    "thw,stride",
    [((4, 16, 16), (1, 8, 8)), ((4, 16, 16), (1, 2, 2)), ((4, 8, 8), (1, 1, 1)), ((4, 8, 8), (1, 4, 4))],
)
def test_depthwise_pool_conv(thw, stride):
    """The q/k/v pooling conv: kernel (3,3,3), padding 1, at the flagship strides."""
    rng = np.random.default_rng(1)
    c = 24
    x = rng.standard_normal((2, *thw, c)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 1, c)).astype(np.float32) * 0.2
    want = jops.depthwise_conv3d(jnp.asarray(w), jnp.asarray(x), stride, (1, 1, 1))
    got = tops.depthwise_conv3d(_t(x), _t(_oidhw(w)), stride, (1, 1, 1))
    _close(got, want)


@pytest.mark.parametrize("stride", [(1, 2, 2), (2, 1, 1)])
def test_depthwise_conv_transpose(stride):
    """The decoder's Q upsample, with output_padding = stride - 1."""
    rng = np.random.default_rng(2)
    c = 16
    x = rng.standard_normal((2, 4, 4, 6, c)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 1, c)).astype(np.float32) * 0.2
    op = tuple(s - 1 for s in stride)
    want = jops.depthwise_conv_transpose3d(jnp.asarray(w), jnp.asarray(x), stride, (1, 1, 1), op)
    got = tops.depthwise_conv_transpose3d(_t(x), _t(_oidhw(w)), stride, (1, 1, 1), op)
    assert tuple(got.shape) == np.asarray(want).shape
    _close(got, want)


def test_max_pool_skip_negative_inputs():
    """-inf padding: with all-negative inputs a zero pad would win the max."""
    rng = np.random.default_rng(3)
    x = -np.abs(rng.standard_normal((2, 4, 8, 8, 12))).astype(np.float32) - 1.0
    want = jops.max_pool3d(jnp.asarray(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))
    got = tops.max_pool3d(_t(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))
    assert float(got.max()) < -1.0
    _close(got, want)


@pytest.mark.parametrize("scale", [(2, 1, 1), (1, 2, 2), (1, 1.5, 1.5)])
def test_trilinear_resize(scale):
    """x2 axes take the separable two-tap path; other sizes F.interpolate."""
    rng = np.random.default_rng(4)
    t, h, w = 4, 6, 8
    x = rng.standard_normal((2, t, h, w, 5)).astype(np.float32)
    size = (int(t * scale[0]), int(h * scale[1]), int(w * scale[2]))
    want = jops.trilinear_resize(jnp.asarray(x), size)
    got = tops.trilinear_resize(_t(x), size)
    _close(got, want)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_layer_norm(eps):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 17, 96)) * 3 + 1).astype(np.float32)
    s = rng.standard_normal((96,)).astype(np.float32)
    b = rng.standard_normal((96,)).astype(np.float32)
    want = jops.layer_norm({"scale": jnp.asarray(s), "bias": jnp.asarray(b)}, jnp.asarray(x), eps=eps)
    got = tops.layer_norm(_t(x), _t(s), _t(b), eps=eps)
    _close(got, want)


def test_layer_norm_eps_matters():
    """The two eps values are distinguishable at this bar on a low-variance row."""
    x = np.full((1, 8), 1.0, np.float32)
    x[0, 0] += 3e-3
    s, b = np.ones(8, np.float32), np.zeros(8, np.float32)
    a = tops.layer_norm(_t(x), _t(s), _t(b), eps=1e-6)
    c = tops.layer_norm(_t(x), _t(s), _t(b), eps=1e-5)
    assert float((a - c).abs().max()) > TOL


def test_gelu_and_linear_and_mlp():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((4, 32)) * 3).astype(np.float32)
    _close(tops.gelu(_t(x)), jops.gelu(jnp.asarray(x)))
    w1 = rng.standard_normal((32, 64)).astype(np.float32) * 0.1
    b1 = rng.standard_normal((64,)).astype(np.float32)
    w2 = rng.standard_normal((64, 16)).astype(np.float32) * 0.1
    b2 = rng.standard_normal((16,)).astype(np.float32)
    p = {"fc1": {"w": jnp.asarray(w1), "b": jnp.asarray(b1)},
         "fc2": {"w": jnp.asarray(w2), "b": jnp.asarray(b2)}}
    _close(tops.linear(_t(x), _t(w1.T), _t(b1)), jops.linear_apply(p["fc1"], jnp.asarray(x)))
    _close(tops.mlp(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2)), jops.mlp_apply(p, jnp.asarray(x)))

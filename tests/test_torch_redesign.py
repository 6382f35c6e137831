"""The functions the Hopper bodies of K1 and B5 must compute, pinned on the CPU
against the JAX package's Pallas kernels in interpret mode: K1's plain twin at
the Q-pool shape (Lq 256, Lk 1024: v14, a3) and with the in-frame mask in
bf16, the plain model of K1's key split and merge at 1-4 splits, the split
count the wrapper picks, and B5's plain twin at a d3-like block (384 -> 192,
four heads, stride (1,2,2)). ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold the CUDA bodies against these same plain functions on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from csts_tpu.kernels import attention as jka
from csts_tpu.kernels import block as jkb
from csts_tpu.models import mvit as jmvit
from csts_torch.kernels import attention as ka
from test_torch_blocks import _pair, _port

torch.set_num_threads(2)

K1_BF16_BAR = 3e-2  # chip_smoke's bf16 bar of K1, times max(1, max|ref|)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qkv(b, n, lq, lk, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, n, lq, hd), (b, n, lk, hd), (b, n, lk, hd))]


def _jax(q, k, v, scale, mask=None):
    return np.asarray(jka.fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
        None if mask is None else jnp.asarray(mask), interpret=True))


def _bf16_mask():
    """The spatial fusion's in-frame mask as the bf16 model holds it, and the
    same values widened to fp32 (exactly) for the JAX kernel."""
    m16 = torch.from_numpy(jmvit.build_inframe_mask((4, 8, 8), 4)).to(torch.bfloat16)
    return m16, m16.float().numpy()


def test_k1_plain_at_the_qpool_shape():
    """v14 / a3: Lq 256 against Lk 1024 keys, head dim 96."""
    q, k, v = _qkv(1, 2, 256, 1024, 96)
    got = ka.fused_attention(_t(q), _t(k), _t(v), 96 ** -0.5)
    np.testing.assert_allclose(got.numpy(), _jax(q, k, v, 96 ** -0.5), atol=2e-5, rtol=0)


def test_k1_plain_with_bf16_mask():
    """The mask in its own dtype (bf16) gives the result of its exact fp32 widening."""
    q, k, v = _qkv(1, 2, 260, 260, 96, seed=1)
    m16, m32 = _bf16_mask()
    got = ka.fused_attention(_t(q), _t(k), _t(v), 96 ** -0.5, m16)
    np.testing.assert_allclose(got.numpy(), _jax(q, k, v, 96 ** -0.5, m32), atol=2e-5, rtol=0)


SPLIT_CASES = [  # (lq, lk, masked)
    (256, 1024, False),   # v14 / a3
    (100, 1000, False),   # ragged keys: the last chunk and the last split short
    (260, 260, True),     # the masked site, five chunks
]


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("lq,lk,masked", SPLIT_CASES)
def test_split_model_matches_pallas(lq, lk, masked, splits):
    """The key split and its merge compute K1's function: fp32 at K1's CPU
    bar, bf16 inputs at its card bar."""
    q, k, v = _qkv(1, 2, lq, lk, 96, seed=splits)
    m16, m32 = _bf16_mask() if masked else (None, None)
    scale = 96 ** -0.5
    want = _jax(q, k, v, scale, m32)
    got = ka.fused_attention_split_plain(_t(q), _t(k), _t(v), scale, splits, m16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    # bf16: the inputs rounded once; the reference is fp32 on the rounded values
    q16, k16, v16 = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    want16 = _jax(*(a.float().numpy() for a in (q16, k16, v16)), scale, m32)
    got16 = ka.fused_attention_split_plain(q16, k16, v16, scale, splits, m16)
    assert got16.dtype == torch.bfloat16
    bar = K1_BF16_BAR * max(1.0, float(np.abs(want16).max()))
    assert float(np.abs(got16.float().numpy() - want16).max()) <= bar


@pytest.mark.parametrize("bn,lq,lk,want", [
    (64, 256, 1024, 1),    # v14 / a3 at batch 8: 128 blocks already fill 132 SMs
    (8, 256, 1024, 4),     # batch 1: 16 blocks, as many splits as allowed
    (16, 256, 1024, 4),    # batch 2: 32 blocks x 4 still one wave
    (32, 256, 1024, 2),    # batch 4: 64 blocks x 2
    (32, 1024, 256, 1),    # v4-v13: four chunks only
    (64, 8, 8, 1),         # temporal fusion
    (64, 260, 260, 1),     # the masked site: five chunks
    (64, 1024, 64, 1),     # d1
])
def test_key_splits(bn, lq, lk, want):
    assert ka.key_splits(bn, lq, lk, 132) == want


@pytest.mark.parametrize("bn,lq,want", [
    (32, 1024, 2),    # v4-v13: 256 tiles of 128 rows on 132 SMs
    (64, 256, 1),     # v14 / a3, v15: 128 tiles, one wave already
    (64, 260, 2),     # the masked site: 3 tiles a (batch, head)
    (64, 1024, 4),    # d1
    (64, 8, 1),       # temporal fusion: 64-row tiles
    (32, 16384, 32),  # B5's attention at d3
])
def test_query_tiles_per_block(bn, lq, want):
    assert ka.query_tiles_per_block(bn, lq, 132) == want


@pytest.mark.parametrize("lk,splits", [(1024, 3), (1000, 4), (260, 2), (64, 1), (130, 4)])
def test_split_ranges_cover_the_keys(lk, splits):
    """Whole 64-key chunks, in order, covering [0, Lk) once, none empty."""
    r = ka.split_ranges(lk, splits)
    assert r[0][0] == 0 and r[-1][1] == lk and len(r) <= splits
    assert all(a < b and a % ka.KEY_CHUNK == 0 for a, b in r)
    assert all(r[i][1] == r[i + 1][0] for i in range(len(r) - 1))


# (dim, dim_out, heads, thw, stride_q, stride_kv): decoder[2]-like (d3) at a
# reduced grid, four heads of 96
D3_CASE = (384, 192, 4, (2, 8, 8), (1, 2, 2), (1, 2, 2))


def test_fused_decoder_block_d3_matches_pallas():
    dim, dim_out, heads, thw, sq, skv = D3_CASE
    jspec, params, block = _pair(dim, dim_out, heads, sq, skv, upsample=True, seed=5)
    x = (np.random.default_rng(5).standard_normal((1, int(np.prod(thw)), dim)) * 0.5
         ).astype(np.float32)
    xj = jnp.asarray(x)
    k, v = jmvit._pooled_kv(params, jspec, xj, thw)
    q5 = jmvit._coarse_q_slots(params, jspec, xj, thw)
    thw_f = jmvit._static_upsample_out(thw, jspec.kernel_q, sq, jspec.padding_q,
                                       jspec.output_padding_q)
    skip, _ = jmvit.upsample_tokens_trilinear(xj, thw, sq)
    want = jkb.fused_decoder_block(q5, skip, k, v, params, jspec, thw_f, interpret=True)
    got, got_thw = _port(block, x, thw, "decoder_block")
    assert got_thw == tuple(thw_f)
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-5, rtol=1e-4)

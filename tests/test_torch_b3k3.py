"""The repaired head dims and the plans of the redesigned B3 and K3, pinned
on the CPU against the JAX package's Pallas kernels in interpret mode:

* B3's split (``kb.fused_block_split_plain``: phase 1's LN1 rows into a Q
  GEMM, K1's body, then B4's back with fp32 res1 and K2's split tail, at the
  new rounding points), run through the block in place of the kernel, against
  ``fused_block`` at v0/a0-like and v2-like widths (the "loop" variant) and
  at 4 and 8 heads (the "hg" and "bd" variants, B9b/B9c);
* K3's sliding window (``kup.t2_upsample_window_plain``) against
  ``t2_upsample_padded``, fp32 and bf16;
* the streamed attention bodies' plan (the logits summed over 64-column
  steps of the head dim; ``ka.fused_attention_streamed_plain``,
  ``ka.fused_attention_bwd_streamed_plain``) against ``fused_attention`` and
  ``_flash_bwd_impl`` at the fp32 head dims 256 and 320 and the bf16 head
  dims 448 and 512 (run in fp32 there, the plan's algebra);
* the fit mirror's knowledge of B3's split instances and the profiler's
  families of the new kernel names.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the CUDA bodies
against the plain twins on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import B8_BAR, bf16_bar
from csts_tpu.kernels import attention as jka
from csts_tpu.kernels import block as jkb
from csts_tpu.kernels import upsample as jkup
from csts_tpu.models import mvit as jmvit
from csts_torch.kernels import attention as ka
from csts_torch.kernels import block as kb
from csts_torch.kernels import upsample as kup
from csts_torch.models import mvit as tmvit
from test_torch_b9 import BD_CASES, HG_CASES
from test_torch_blocks import B3_CASES, _pair

torch.set_num_threads(2)


def _through_split(block, x, thw, fn):
    """The block's whole-block route with ``fn`` in place of ``kb.fused_block``
    (``forward_block``: phase 1, then the kernel's arguments); returns the
    output and the arguments the kernel was called with."""
    calls = []
    orig = kb.fused_block
    try:
        kb.fused_block = lambda *a: calls.append(a) or fn(*a)
        with torch.no_grad():
            out, out_thw = block.forward_block(x, thw)
    finally:
        kb.fused_block = orig
    assert len(calls) == 1 and out_thw == thw
    return out, calls[0]


@pytest.mark.parametrize("dim,dim_out,heads,thw,skv", B3_CASES, ids=["v0-like", "v2-like"])
def test_block_split_model_matches_pallas(dim, dim_out, heads, thw, skv):
    """B3's split at the flagship's (dim, dim_out, heads) of v0/a0 and v2, at
    reduced grids, against ``_block_kernel``, fp32, B3's bar."""
    jspec, params, block = _pair(dim, dim_out, heads, (), skv, seed=21)
    assert tmvit.block_route(block.spec, None, thw) == "block"
    assert tmvit._split_instance("block", block.spec)
    x = np.random.default_rng(21).standard_normal((2, int(np.prod(thw)), dim)).astype(np.float32)
    k, v = jmvit._pooled_kv(params, jspec, jnp.asarray(x), thw)
    want = jkb.fused_block(jnp.asarray(x), k, v, params, jspec, interpret=True, variant="loop")
    got, _ = _through_split(block, torch.from_numpy(x), thw, kb.fused_block_split_plain)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("variant,dim,dim_out,heads,thw,skv",
                         [("hg", *c) for c in HG_CASES] + [("bd", *c) for c in BD_CASES])
def test_block_split_model_multihead_matches_pallas(variant, dim, dim_out, heads, thw, skv):
    """B3's split at 4 and 8 heads (B9b/B9c, the widths ab_block runs)
    against the head-grid and block-diagonal kernels, fp32, B3's bar."""
    jspec, params, block = _pair(dim, dim_out, heads, (), skv, seed=22)
    assert tmvit._split_instance("block", block.spec)
    x = np.random.default_rng(22).standard_normal((1, int(np.prod(thw)), dim)).astype(np.float32)
    k, v = jmvit._pooled_kv(params, jspec, jnp.asarray(x), thw)
    want = jkb.fused_block(jnp.asarray(x), k, v, params, jspec, interpret=True, variant=variant)
    got, _ = _through_split(block, torch.from_numpy(x), thw, kb.fused_block_split_plain)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("dim,dim_out,heads,thw,skv", B3_CASES, ids=["v0-like", "v2-like"])
def test_block_split_model_bf16_within_the_card_bar(dim, dim_out, heads, thw, skv):
    """In bf16 the split model and the first design's plain twin round at the
    same points but p (unnormalised against normalised): within B3's card
    bar."""
    _, _, block = _pair(dim, dim_out, heads, (), skv, seed=23)
    block = block.to(torch.bfloat16)
    x = torch.from_numpy((np.random.default_rng(23).standard_normal(
        (2, int(np.prod(thw)), dim))).astype(np.float32)).to(torch.bfloat16)
    got, args = _through_split(block, x, thw, kb.fused_block_split_plain)
    with torch.no_grad():
        want = kb.fused_block_plain(*args)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= bf16_bar("block", want)


@pytest.mark.parametrize("t_c,h,w,c", [(1, 4, 8, 24), (2, 4, 4, 5), (4, 8, 8, 13), (4, 4, 8, 192)])
def test_t2_window_matches_pallas(t_c, h, w, c):
    """K3's sliding window at T_c 1, 2 and 4, C 5 and 13 (no multiple of 8)
    among them, against ``t2_upsample_padded``: fp32 within 1e-6, bf16 bit
    for bit (the same products and sum, each rounded on its own)."""
    x = np.random.default_rng(t_c * c).standard_normal((2, t_c * h * w, c)).astype(np.float32)
    want = jkup.t2_upsample_padded(jnp.asarray(x), (t_c, h, w), interpret=True)[..., :c]
    got = kup.t2_upsample_window_plain(torch.from_numpy(x), (t_c, h, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jkup.t2_upsample_padded(xb, (t_c, h, w), interpret=True)[..., :c]
    got = kup.t2_upsample_window_plain(torch.from_numpy(x).to(torch.bfloat16), (t_c, h, w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert torch.equal(got, kup.t2_upsample_plain(torch.from_numpy(x).to(torch.bfloat16),
                                                  (t_c, h, w)))


@pytest.mark.parametrize("hd,lq,lk", [(256, 72, 40), (320, 33, 70), (448, 40, 130),
                                      (512, 65, 24)])
def test_streamed_attention_matches_pallas(hd, lq, lk):
    """The streamed body's plan (fp32 at any head dim; bf16 above 384, its
    algebra run here in fp32): logits over 64-column steps, the online
    softmax per 64-key chunk, against ``fused_attention``, fp32, K1's bar."""
    rng = np.random.default_rng(hd)
    q, k, v = (rng.standard_normal((1, 2, n, hd)).astype(np.float32) for n in (lq, lk, lk))
    scale = hd ** -0.5
    assert ka.streamed(hd, torch.float32) and ka.streamed(hd, torch.bfloat16) == (hd > 384)
    want = jka.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, None,
                               interpret=True)
    got = ka.fused_attention_streamed_plain(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("hd,lq,lk", [(256, 72, 40), (320, 33, 70), (448, 40, 130),
                                      (512, 65, 24)])
def test_streamed_attention_bwd_matches_pallas(hd, lq, lk):
    """B8's streamed passes' plan (S and dP over 64-column steps, p from the
    rows' log-sum-exp) against ``_flash_bwd_impl``, fp32, the bar of
    ``test_attention_bwd_matches_pallas``."""
    rng = np.random.default_rng(hd + 1)
    q, k, v = (rng.standard_normal((1, 2, n, hd)).astype(np.float32) for n in (lq, lk, lk))
    g = rng.standard_normal((1, 2, lq, hd)).astype(np.float32)
    scale = hd ** -0.5
    out = jka._fused_attention_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                                        scale, True)
    want = jka._flash_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out,
                               jnp.asarray(g), scale, True)
    got = ka.fused_attention_bwd_streamed_plain(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, out, g)), scale)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("hd", [448, 512])
def test_streamed_attention_bf16_within_the_card_bars(hd):
    """In bf16 the streamed plan rounds where the plain twins do (K1: p
    unnormalised against normalised): within K1's and B8's card bars."""
    rng = np.random.default_rng(hd + 2)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 2, n, hd)).astype(np.float32)
                                   ).to(torch.bfloat16) for n in (40, 70, 70, 40))
    scale = hd ** -0.5
    got = ka.fused_attention_streamed_plain(q, k, v, scale)
    want = ka.fused_attention_plain(q, k, v, scale)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= bf16_bar("attention", want)
    for x, y in zip(ka.fused_attention_bwd_streamed_plain(q, k, v, want, g, scale),
                    ka.fused_attention_bwd_plain(q, k, v, want, g, scale)):
        bar = B8_BAR[torch.bfloat16] * max(1.0, float(y.float().abs().max()))
        assert float((x.float() - y.float()).abs().max()) <= bar


@pytest.mark.parametrize("hd,dtype,want", [
    (448, torch.bfloat16, 448), (449, torch.bfloat16, 450), (512, torch.bfloat16, 512),
    (1000, torch.bfloat16, 1000), (320, torch.float32, 320), (2048, torch.float32, 2048),
])
def test_streamed_head_dims(hd, dtype, want):
    """Above 384 in bf16, and at any head dim in fp32, the streamed bodies
    take the head dim itself (made even for B8); their column blocks are
    one."""
    assert ka.streamed(hd, dtype)
    assert ka.kernel_head_dim(hd, dtype) == want
    if dtype == torch.bfloat16:
        assert ka.column_blocks(want) == (1, 1, 1)


def _aspec(dim, dim_out, heads):
    return tmvit.AttentionSpec(dim=dim, dim_out=dim_out, num_heads=heads)


@pytest.mark.parametrize("dim,dim_out,heads,split", [
    (96, 192, 1, True), (192, 384, 2, True), (96, 96, 1, True), (192, 192, 2, True),
    (384, 384, 4, True), (384, 768, 4, True), (768, 768, 8, True),
    (288, 288, 3, False), (128, 128, 1, False), (192, 384, 1, False),
])
def test_fit_mirror_knows_b3_split(dim, dim_out, heads, split):
    """The mirror of block.cu's split instances (head dim 96 at the
    flagship's and ab_block's widths); every width keeps a body that fits
    (the split, else the first design's)."""
    spec = _aspec(dim, dim_out, heads)
    assert tmvit._split_instance("block", spec) == split
    assert tmvit.whole_block_fits("block", spec)
    # the wrapper's predicate (which sizes the split's scratch) is the same,
    # and wants the dim-change proj exactly where dim != dim_out
    hd = dim // heads
    assert kb.split_instance("block", dim, dim_out, 4 * dim, hd, dim != dim_out) == split
    assert not kb.split_instance("block", dim, dim_out, 4 * dim, hd, dim == dim_out)


@pytest.mark.parametrize("name,family", [
    ("void (anonymous namespace)::block_ln_kernel(float const*, __nv_bfloat16 const*)",
     "B3 block"),
    ("void (anonymous namespace)::block_q_kernel<96>(CUtensorMap_st)", "B3 block"),
    ("void (anonymous namespace)::block_attn_kernel<96>(CUtensorMap_st)", "B3 block"),
    ("void (anonymous namespace)::block_proj_kernel<192, 4>(CUtensorMap_st, float*)",
     "B3 block"),
    ("void (anonymous namespace)::pool_proj_kernel<192, 4>(CUtensorMap_st, float*)",
     "B4 pool_block"),
    ("void (anonymous namespace)::block_fc1_kernel<64>(CUtensorMap_st)", "B3 block"),
    ("void (anonymous namespace)::block_fc2_kernel<true, 192>(CUtensorMap_st)", "B3 block"),
    ("void csts::fb::block_mma_kernel<1, 2, 6, 6, 128>(csts::fb::Args)",
     "B3-B5, B9b/c whole blocks"),
    ("void (anonymous namespace)::t2_upsample_kernel<__nv_bfloat16, 8>(__nv_bfloat16 const*)",
     "K3 t2_upsample"),
    ("void (anonymous namespace)::attn_streamed_kernel<float>(csts::attn::AttnArgs, int)",
     "K1 attention"),
    ("void (anonymous namespace)::dq_streamed_kernel<__nv_bfloat16>(BwdArgs, int)",
     "B8 attention_bwd"),
    ("void (anonymous namespace)::dkdv_streamed_kernel<float>(BwdArgs, int)",
     "B8 attention_bwd"),
])
def test_profile_families_of_b3_k3(name, family):
    """The profiler files B3's six kernels under their own family (its
    GEMMs not under K2's or the matmuls, its LN not under K2's), the first
    design with the whole blocks, K3's window under K3 and the streamed
    attention bodies under K1 and B8."""
    from csts_torch.tools import profile_forward

    assert profile_forward.family(name) == family

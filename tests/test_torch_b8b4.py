"""The repairs at other widths and the plans of the redesigned B8 and B4,
pinned on the CPU against the JAX package's Pallas kernels in interpret mode:

* K2 and B7 at widths that are not multiples of 16: the wrapper's plan
  (``kb.pad_tail``: rows and weights zero-padded to multiples of 16, LN2's
  statistics over the true width, the outputs sliced back) through the plain
  model of the split tail, against ``fused_mlp_tail`` and
  ``fused_mlp_tail_train``;
* K1 and B8 at bf16 head dims above 192: the plan of padding to 256 or 384
  and splitting the output columns over blocks (``ka.column_blocks``, each
  block recomputing the logits over the whole head dim), against
  ``fused_attention`` and ``_flash_bwd_impl``;
* the whole-block predicates' shared-memory fit (``whole_block_fits``), a
  mirror of ``csrc/fused_block.cuh``'s sizes;
* the plain model of B4's split (``kb.fused_pool_block_split_plain``, the
  rounding points of its three launches) through the block at all four
  flagship (dim, dim_out, heads) triples against ``fused_pool_block``.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the CUDA bodies
against the plain twins on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import bf16_bar
from csts_tpu.kernels import attention as jka
from csts_tpu.kernels import block as jkb
from csts_torch.kernels import attention as ka
from csts_torch.kernels import block as kb
from csts_torch.models import mvit as tmvit
from test_torch_blocks import POOL_CASES, _jax_pool, _pair
from test_torch_tail import _spec, _tail
from test_torch_train_kernels import _tail_params

torch.set_num_threads(2)

# (dim, dim_out): a width off 16 with the dim-change proj, and an identity one
OFF16_PAIRS = [(40, 72), (40, 40)]


def _padded_split(x, tail, dp=None):
    """The wrapper's plan on the CPU: pad, the split model with LN2 over the
    true width, slice back."""
    c, h, cout = x.shape[-1], tail[2].shape[0], tail[4].shape[0]
    xp, *wp = kb.pad_tail(x, *tail)
    assert xp.shape[-1] % 16 == 0 and wp[2].shape[0] % 16 == 0 and wp[4].shape[0] % 16 == 0
    got = kb.fused_mlp_tail_split_plain(xp, *wp, dp, ln_width=c)
    if dp is None:
        return got[..., :cout]
    return got[0][..., :cout], got[1][..., :h]


@pytest.mark.parametrize("dim,dim_out", OFF16_PAIRS)
def test_padded_tail_matches_pallas_k2(dim, dim_out):
    """K2 at widths off 16 (C 40, H 160): the padded plan against
    ``_mlp_tail_kernel``, fp32, 2 x 37 rows, K2's bar."""
    spec = _spec(dim, dim_out, False)
    params = _tail_params(spec, 3)
    x = np.random.default_rng(3).standard_normal((2, 37, dim)).astype(np.float32)
    want = jkb.fused_mlp_tail(jnp.asarray(x), params, spec, interpret=True)
    got = _padded_split(torch.from_numpy(x), _tail(params, False))
    assert tuple(got.shape) == (2, 37, dim_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("dim,dim_out", OFF16_PAIRS)
def test_padded_tail_matches_pallas_b7(dim, dim_out):
    """B7 at widths off 16 with one sample's MLP branch dropped: the padded
    plan's out against ``_mlp_tail_train_kernel`` and its stored hidden,
    sliced back, against the unpadded plain twin's."""
    spec = _spec(dim, dim_out, False)
    params = _tail_params(spec, 4)
    x = np.random.default_rng(4).standard_normal((3, 29, dim)).astype(np.float32)
    dp = np.asarray([0.0, 1 / 0.9, 1 / 0.9], np.float32)
    want = jkb.fused_mlp_tail_train(jnp.asarray(x), params, spec, jnp.asarray(dp),
                                    interpret=True)
    tail = _tail(params, False)
    out, hid = _padded_split(torch.from_numpy(x), tail, torch.from_numpy(dp))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)
    _, hid_plain = kb.fused_mlp_tail_train_plain(torch.from_numpy(x), *tail, torch.from_numpy(dp))
    assert hid.shape == hid_plain.shape
    np.testing.assert_allclose(hid.numpy(), hid_plain.numpy(), atol=1e-5, rtol=1e-5)


def test_padded_tail_bf16_within_the_card_bar():
    """In bf16 the padded plan rounds where the plain twin does: within K2's
    card bar."""
    spec = _spec(40, 72, False)
    tail = [None if t is None else t.to(torch.bfloat16) for t in _tail(_tail_params(spec, 5),
                                                                      False)]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 45, 40)).astype(
        np.float32)).to(torch.bfloat16)
    want = kb.fused_mlp_tail_plain(x, *tail)
    got = _padded_split(x, tail)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= bf16_bar("mlp_tail", want)


@pytest.mark.parametrize("hd,lq,lk", [(256, 72, 40), (200, 33, 70), (384, 40, 24)])
def test_column_split_attention_matches_pallas(hd, lq, lk):
    """K1's plan above head dim 192 (padded to 256 or 384, output columns in
    128-column blocks over the whole head dim's logits) against
    ``fused_attention``, fp32, K1's bar."""
    rng = np.random.default_rng(hd)
    q, k, v = (rng.standard_normal((1, 2, n, hd)).astype(np.float32) for n in (lq, lk, lk))
    scale = hd ** -0.5
    assert ka.column_blocks(ka.kernel_head_dim(hd, torch.bfloat16))[0] > 1
    want = jka.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, None,
                               interpret=True)
    got = ka.fused_attention_columns_plain(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("hd,lq,lk", [(256, 72, 40), (384, 40, 24)])
def test_column_split_attention_bwd_matches_pallas(hd, lq, lk):
    """B8's plan above head dim 192 (dq in 128-column blocks, dk and dv in
    64- or 96-column ones, p and dl over the whole head dim) against
    ``_flash_bwd_impl``, fp32, the bar of ``test_attention_bwd_matches_pallas``."""
    rng = np.random.default_rng(hd + 1)
    q, k, v = (rng.standard_normal((1, 2, n, hd)).astype(np.float32) for n in (lq, lk, lk))
    g = rng.standard_normal((1, 2, lq, hd)).astype(np.float32)
    scale = hd ** -0.5
    out = jka._fused_attention_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                                        scale, True)
    want = jka._flash_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out,
                               jnp.asarray(g), scale, True)
    got = ka.fused_attention_bwd_columns_plain(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, out, g)), scale)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == y.shape
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("hd,want", [(96, (1, 1, 1)), (128, (1, 1, 2)), (192, (1, 1, 2)),
                                     (256, (2, 2, 4)), (384, (3, 3, 4))])
def test_column_blocks(hd, want):
    """The column blocks of K1, B8's dq pass and its dk/dv pass, as the CUDA
    plans hold them (at most 192 dq columns, 96 dk and dv columns a block)."""
    assert ka.column_blocks(hd) == want


def _aspec(dim, dim_out, heads, **kw):
    return tmvit.AttentionSpec(dim=dim, dim_out=dim_out, num_heads=heads, **kw)


DEC = dict(kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3), stride_q=(1, 2, 2), stride_kv=(1, 1, 1),
           upsample_q=True)


def test_whole_block_fit_mirrors_fused_block():
    """The mirror of ``Plan::smem_bytes`` gives the sizes the sources state:
    the d768 / 8-head instance of B3 takes 230,912 bytes (block.cu), and at
    WR 1 with head dim 256 the widest instance holds C = 684 but not 768."""
    assert tmvit._fb_smem(1, 12, 12, 768, 96) == 230912
    assert tmvit._fb_smem(1, 12, 12, 684, 256) <= tmvit._SMEM_MAX
    assert tmvit._fb_smem(1, 12, 12, 688, 256) > tmvit._SMEM_MAX


def test_unfit_width_routes_to_k1_k2():
    """A decoder block of dim 768 with three heads of 256 fits no instance of
    B5: it takes K1+K2 before any launch. Its neighbours that fit keep their
    whole-block routes; a B3 block at head dim 256 and dim 512 fits."""
    thw = (4, 8, 8)
    unfit = _aspec(768, 384, 3, **DEC)
    assert unfit.head_dim == 256
    assert not tmvit.whole_block_fits("decoder_block", unfit)
    assert tmvit.block_route(unfit, None, thw) == "composite"
    assert tmvit.block_route(_aspec(768, 384, 4, **DEC), None, thw) == "decoder_block"
    assert tmvit.block_route(_aspec(384, 192, 2, **DEC), None, thw) == "decoder_block"
    assert tmvit.whole_block_fits("block", _aspec(512, 512, 2))
    assert tmvit.block_route(_aspec(512, 512, 2), None, thw) == "block"


@pytest.mark.parametrize("dim,dim_out,heads,skv", [
    (192, 192, 2, (1, 4, 4)), (192, 384, 2, (1, 4, 4)),
    (384, 384, 4, (1, 2, 2)), (384, 768, 4, (1, 2, 2)),
], ids=["v1", "a1", "v3", "a2"])
def test_pool_block_split_model_matches_pallas(dim, dim_out, heads, skv, monkeypatch):
    """B4's split at the four flagship (dim, dim_out, heads) triples, at a
    reduced grid (4 x 16 x 32 fine): the plain model of its three launches,
    run through the block in place of the kernel, against
    ``_pool_block_kernel``, fp32, B4's bar."""
    thw = (4, 16, 32)
    jspec, params, block = _pair(dim, dim_out, heads, (1, 2, 2), skv, seed=12)
    assert tmvit.block_route(block.spec, None, thw) == "pool_block"
    x = (np.random.default_rng(12).standard_normal((1, int(np.prod(thw)), dim)) * 0.5
         ).astype(np.float32)
    calls = []

    def split(*args):
        calls.append(1)
        return kb.fused_pool_block_split_plain(*args)
    monkeypatch.setattr(kb, "fused_pool_block", split)
    with torch.no_grad():
        got, got_thw = block(torch.from_numpy(x), thw)
    assert calls and got_thw == (4, 8, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_pool(jspec, params, x, thw)),
                               atol=5e-5, rtol=1e-4)


def test_pool_block_split_model_bf16_within_the_card_bar():
    """In bf16 the split model and the first design's plain twin round at the
    same points but p (unnormalised against normalised): within B4's card bar."""
    dim, dim_out, heads, thw, skv = POOL_CASES[1]
    _, _, block = _pair(dim, dim_out, heads, (1, 2, 2), skv, seed=13)
    block = block.to(torch.bfloat16)
    x = torch.from_numpy((np.random.default_rng(13).standard_normal(
        (1, int(np.prod(thw)), dim)) * 0.5).astype(np.float32)).to(torch.bfloat16)
    args = []
    orig = kb.fused_pool_block
    try:
        kb.fused_pool_block = lambda *a: args.append(a) or orig(*a)
        with torch.no_grad():
            block(x, thw)
    finally:
        kb.fused_pool_block = orig
    with torch.no_grad():
        want = kb.fused_pool_block_plain(*args[0])
        got = kb.fused_pool_block_split_plain(*args[0])
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= bf16_bar("pool_block", want)


@pytest.mark.parametrize("name,family", [
    ("void (anonymous namespace)::dq_wg_kernel<96>(CUtensorMap_st, CUtensorMap_st)",
     "B8 attention_bwd"),
    ("void (anonymous namespace)::dkdv_wg_kernel<192>(CUtensorMap_st, CUtensorMap_st)",
     "B8 attention_bwd"),
    ("void (anonymous namespace)::pool_conv_kernel(csts::fb::Args, __nv_bfloat16*, int)",
     "B4 pool_block"),
    ("void (anonymous namespace)::pool_attn_kernel<96>(CUtensorMap_st)", "B4 pool_block"),
    ("void (anonymous namespace)::pool_proj_kernel<192>(CUtensorMap_st, float*)",
     "B4 pool_block"),
    ("void (anonymous namespace)::pool_ln_kernel(float const*, __nv_bfloat16 const*)",
     "B4 pool_block"),
    ("void (anonymous namespace)::pool_fc1_kernel<64>(CUtensorMap_st)", "B4 pool_block"),
    ("void (anonymous namespace)::pool_fc2_kernel<false, 192>(CUtensorMap_st)",
     "B4 pool_block"),
    ("void (anonymous namespace)::tail_fc2_kernel<false, true, 192>(CUtensorMap_st)",
     "K2 mlp_tail"),
    ("void (anonymous namespace)::decoder_tail_kernel<768, 384, 0, 96, 96, 64, 4>"
     "(CUtensorMap_st)", "B5 decoder_block"),
    ("void csts::fb::block_mma_kernel<1, 2, 6, 6, 128>(csts::fb::Args)",
     "B3-B5, B9b/c whole blocks"),
])
def test_profile_families_of_the_redesigns(name, family):
    """The profiler files B8's two passes and B4's seven kernels under their
    own families (B4's Q conv not under the convolutions, its GEMMs not
    under K2's), and B4's first design with the whole blocks."""
    from csts_torch.tools import profile_forward

    assert profile_forward.family(name) == family

"""The function the Hopper body of K2 and B7 computes, and the repairs around
the port's kernels, pinned on the CPU:

* the plain model of the tail split at the hidden (LN2 -> G -> fc2 + proj,
  ``kb.fused_mlp_tail_split_plain``) against the Pallas kernels in
  interpret mode at the flagship's (C, H, C_out) sites, fp32, and against
  the plain twins in bf16 at the card's bar;
* K1's and B8's head-dim padding (a padded call of the plain twins against
  the unpadded one), and the head dim each dtype runs at;
* ``MODEL.ACT_CHECKPOINT`` raising in the training entry points;
* the whole-block predicates' width guard, and the profiler's families for
  the new kernels' names.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the CUDA bodies
against the plain twins on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import bf16_bar
from csts_tpu.kernels import block as jkb
from csts_tpu.models import mvit as jmvit
from csts_torch.convert.from_jax import _block
from csts_torch.kernels import attention as ka
from csts_torch.kernels import block as kb
from csts_torch.models import mvit as tmvit
from csts_torch.models.csts import build_spec
from csts_torch.presets import small_cfg
from csts_torch.tools import profile_forward
from csts_torch.train import step as train_lib
from test_torch_train_kernels import B7_PAIRS, TAIL_NAMES, _tail_params

torch.set_num_threads(2)

K2_PAIRS = [(384, 384, False), (384, 768, False), (768, 768, False)]


def _spec(dim, dim_out, upsample):
    return jmvit.AttentionSpec(
        dim=dim, dim_out=dim_out, num_heads=1,
        kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3), stride_q=(1, 2, 2), stride_kv=(1, 2, 2),
        upsample_q=upsample, fused=True, drop_path=0.1,
    )


def _tail(params, upsample):
    """The port's tail weights (LN2, fc1, fc2, proj) from JAX block params."""
    sd = {}
    _block(sd, "blk", jax.tree_util.tree_map(np.asarray, params), upsample=upsample)
    return [torch.from_numpy(sd[f"blk.{n}"]) if f"blk.{n}" in sd else None for n in TAIL_NAMES]


def _pair_id(c, co, up):
    return f"{c}-{4 * (co if up else c)}-{co}"


@pytest.mark.parametrize("dim,dim_out,upsample", K2_PAIRS,
                         ids=[_pair_id(*p) for p in K2_PAIRS])
def test_split_model_matches_pallas_k2(dim, dim_out, upsample):
    """K2's split (no dp) against ``_mlp_tail_kernel``, fp32, 2 x 37 rows."""
    spec = _spec(dim, dim_out, upsample)
    params = _tail_params(spec, 7)
    x = np.random.default_rng(7).standard_normal((2, 37, dim)).astype(np.float32)
    want = jkb.fused_mlp_tail(jnp.asarray(x), params, spec, interpret=True)
    got = kb.fused_mlp_tail_split_plain(torch.from_numpy(x), *_tail(params, upsample))
    assert tuple(got.shape) == (2, 37, dim_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("dim,dim_out,upsample", B7_PAIRS,
                         ids=[_pair_id(*p) for p in B7_PAIRS])
def test_split_model_matches_pallas_b7(dim, dim_out, upsample):
    """B7's split (dp between fc2 and proj) against ``_mlp_tail_train_kernel``
    with one sample's MLP branch dropped, fp32, 3 x 29 rows; its stored
    hidden against the plain twin's."""
    spec = _spec(dim, dim_out, upsample)
    params = _tail_params(spec, 8)
    x = np.random.default_rng(8).standard_normal((3, 29, dim)).astype(np.float32)
    dp = np.asarray([0.0, 1 / 0.9, 1 / 0.9], np.float32)
    want = jkb.fused_mlp_tail_train(jnp.asarray(x), params, spec, jnp.asarray(dp),
                                    interpret=True)
    tail = _tail(params, upsample)
    out, hid = kb.fused_mlp_tail_split_plain(torch.from_numpy(x), *tail, torch.from_numpy(dp))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)
    _, hid_plain = kb.fused_mlp_tail_train_plain(torch.from_numpy(x), *tail, torch.from_numpy(dp))
    np.testing.assert_allclose(hid.numpy(), hid_plain.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dim,dim_out,upsample", [(96, 192, False), (768, 768, False),
                                                  (768, 384, True)])
def test_split_model_bf16_matches_plain(dim, dim_out, upsample):
    """In bf16 the split rounds at the plain twins' points: within the card's
    bar for K2 and B7 (two bf16 ulps of the largest output), and the stored
    hidden within one ulp."""
    spec = _spec(dim, dim_out, upsample)
    tail = [None if t is None else t.to(torch.bfloat16) for t in _tail(_tail_params(spec, 9),
                                                                      upsample)]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 45, dim)).astype(
        np.float32)).to(torch.bfloat16)
    dp = torch.tensor([0.0, 1.25])
    want = kb.fused_mlp_tail_plain(x, *tail)
    got = kb.fused_mlp_tail_split_plain(x, *tail)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).abs().max()) <= bf16_bar("mlp_tail", want)
    want_o, want_h = kb.fused_mlp_tail_train_plain(x, *tail, dp)
    got_o, got_h = kb.fused_mlp_tail_split_plain(x, *tail, dp)
    assert float((got_o.float() - want_o.float()).abs().max()) <= bf16_bar("mlp_tail", want_o)
    assert float((got_h.float() - want_h.float()).abs().max()) <= 2.0 ** -7 * max(
        1.0, float(want_h.float().abs().max()))


@pytest.mark.parametrize("hd,dtype,want", [
    (16, torch.bfloat16, 64), (32, torch.bfloat16, 64), (64, torch.bfloat16, 64),
    (80, torch.bfloat16, 96), (96, torch.bfloat16, 96), (112, torch.bfloat16, 128),
    (160, torch.bfloat16, 192), (192, torch.bfloat16, 192),
    (16, torch.float32, 16), (17, torch.float32, 18), (256, torch.float32, 256),
])
def test_kernel_head_dim(hd, dtype, want):
    assert ka.kernel_head_dim(hd, dtype) == want


def test_kernel_head_dim_above_192_raises_in_bf16():
    """Above 192 the bf16 wgmma bodies split the output columns (head dims
    256 and 384); above the largest instance the streamed bodies take the
    head dim itself: no bf16 head dim raises any more (448 and 512 run)."""
    assert ka.kernel_head_dim(256, torch.bfloat16) == 256
    assert ka.kernel_head_dim(384, torch.bfloat16) == 384
    assert not ka.streamed(384, torch.bfloat16)
    for hd in (448, 512):
        assert ka.kernel_head_dim(hd, torch.bfloat16) == hd
        assert ka.streamed(hd, torch.bfloat16)


@pytest.mark.parametrize("hd,lq,lk", [(16, 40, 24), (32, 33, 70)])
def test_head_dim_padding_is_exact(hd, lq, lk):
    """What the CUDA wrappers do at a head dim without an instance: the plain
    twins on inputs zero-padded to the next compiled head dim, the outputs
    sliced back, equal the unpadded call (fp32; a sum with extra zero terms
    may regroup, so 1e-6 and not bit-equal)."""
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, n, hd)).astype(np.float32))
               for n in (lq, lk, lk))
    g = torch.from_numpy(rng.standard_normal((2, 3, lq, hd)).astype(np.float32))
    scale = hd ** -0.5
    hdp = ka.kernel_head_dim(hd, torch.bfloat16)
    assert hdp > hd
    qp, kp, vp = ka.pad_head_dim(hdp, q, k, v)
    assert qp.shape[-1] == hdp and float(qp[..., hd:].abs().max()) == 0.0
    out = ka.fused_attention_plain(q, k, v, scale)
    out_p = ka.fused_attention_plain(qp, kp, vp, scale)
    np.testing.assert_allclose(out_p[..., :hd].numpy(), out.numpy(), atol=1e-6, rtol=0)
    assert float(out_p[..., hd:].abs().max()) == 0.0
    want = ka.fused_attention_bwd_plain(q, k, v, out, g, scale)
    outp, gp = ka.pad_head_dim(hdp, out, g)
    got = ka.fused_attention_bwd_plain(qp, kp, vp, outp, gp, scale)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x[..., :hd].numpy(), y.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
        assert float(x[..., hd:].abs().max()) == 0.0, name


def test_act_checkpoint_raises():
    """``MODEL.ACT_CHECKPOINT`` no longer makes the training entry points
    raise: the state and the step build with it, and the model recomputes
    its encoder blocks (``spec.remat``; the gradients against the plain step
    in tests/test_torch_trainer.py). What still raises is a step whose batch
    does not split into its micro-batches."""
    cfg = small_cfg(2)
    cfg.MODEL.ACT_CHECKPOINT = True
    spec = build_spec(cfg)
    assert spec.remat
    state = train_lib.create_train_state(cfg, spec, torch.Generator().manual_seed(0),
                                         device="cpu")
    step = train_lib.make_train_step(cfg, spec, steps_per_epoch=10, accum_steps=3)
    batch = {"video": torch.zeros(2, 8, 32, 32, 3), "audio": torch.zeros(2, 8, 32, 32, 1),
             "labels_hm": torch.full((2, 8, 8, 8), 1.0 / 64)}
    with pytest.raises(ValueError, match="micro-batches"):
        step(state, batch, torch.Generator().manual_seed(0))
    cfg.MODEL.ACT_CHECKPOINT = False
    train_lib.make_train_step(cfg, build_spec(cfg), steps_per_epoch=10)


def _aspec(dim, dim_out, heads, **kw):
    return tmvit.AttentionSpec(dim=dim, dim_out=dim_out, num_heads=heads, **kw)


def test_whole_block_width_guard():
    """B3-B5 take the widths their kernels are built for: a block whose dim,
    dim_out, hidden or head dim is no multiple of 16, or (B3) whose head dim
    is above 256, takes the K1+K2 route; small_cfg's and the flagship's
    widths keep their whole-block routes."""
    thw = (4, 8, 8)
    assert tmvit.block_route(_aspec(16, 32, 1), None, thw) == "block"
    assert tmvit.block_route(_aspec(192, 384, 2), None, thw) == "block"
    assert tmvit.block_route(_aspec(24, 24, 1), None, thw) == "composite"
    assert tmvit.block_route(_aspec(384, 384, 1), None, thw) == "composite"   # head dim 384
    assert tmvit.block_route(_aspec(512, 512, 2), None, thw) == "block"       # head dim 256
    pool = dict(kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3), stride_q=(1, 2, 2),
                stride_kv=(1, 2, 2))
    assert tmvit.block_route(_aspec(32, 64, 2, **pool), None, thw) == "pool_block"
    assert tmvit.block_route(_aspec(40, 80, 2, **pool), None, thw) == "composite"
    dec = dict(kernel_q=(3, 3, 3), kernel_kv=(3, 3, 3), stride_q=(1, 2, 2),
               stride_kv=(1, 1, 1), upsample_q=True)
    assert tmvit.block_route(_aspec(64, 32, 4, **dec), None, thw) == "decoder_block"
    assert tmvit.block_route(_aspec(72, 36, 4, **dec), None, thw) == "composite"


@pytest.mark.parametrize("name,family", [
    ("void (anonymous namespace)::tail_ln_kernel<false>(__nv_bfloat16 const*)", "K2 mlp_tail"),
    ("void (anonymous namespace)::tail_fc1_kernel<false, 96>(CUtensorMap_st)", "K2 mlp_tail"),
    ("void (anonymous namespace)::tail_fc2_kernel<false, true, 192>(CUtensorMap_st)",
     "K2 mlp_tail"),
    ("void (anonymous namespace)::tail_fc1_kernel<true, 64>(CUtensorMap_st)", "B7 mlp_tail_train"),
    ("void (anonymous namespace)::tail_fc2_kernel<true, false, 96>(CUtensorMap_st)",
     "B7 mlp_tail_train"),
    ("void (anonymous namespace)::tail_ln_kernel<true>(__nv_bfloat16 const*)",
     "B7 mlp_tail_train"),
    ("void (anonymous namespace)::mlp_tail_f32_kernel<true>(TailArgs)", "B7 mlp_tail_train"),
])
def test_profile_families_of_the_tail(name, family):
    """The profiler files the new body's three kernels under K2 or B7 (their
    TRAIN flag leads the template list), not under cuBLAS's matmuls."""
    assert profile_forward.family(name) == family

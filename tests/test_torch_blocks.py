"""The port's whole-block kernels B3 (``fused_block``), B4 (``fused_pool_block``)
and B5 (``fused_decoder_block``) against the JAX package's Pallas kernels, run
as the JAX suite runs them on the CPU (interpret mode), and against the port's
own K1+K2 composite of the same block; the dispatch map of the flagship; and
the routing of the reduced model through all three. On the CPU each wrapper
runs its plain PyTorch twin; ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold the CUDA kernels against these twins on the card. All comparisons fp32.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from csts_tpu.kernels import attention as jka
from csts_tpu.kernels import block as jkb
from csts_tpu.models import csts as jcsts
from csts_tpu.models import mvit as jmvit
from csts_torch import presets
from csts_torch.convert.from_jax import _block
from csts_torch.kernels import block as kb
from csts_torch.models import csts as tcsts
from csts_torch.models import mvit as tmvit

torch.set_num_threads(2)


def _pair(dim, dim_out, heads, stride_q, stride_kv, upsample=False, seed=0):
    """One block spec in both packages, JAX-initialised weights loaded into
    the port's ``MultiScaleBlock`` through the port's converter."""
    kq = (3, 3, 3) if stride_q else ()
    jspec = jmvit.AttentionSpec(dim=dim, dim_out=dim_out, num_heads=heads, kernel_q=kq,
                                kernel_kv=(3, 3, 3), stride_q=stride_q, stride_kv=stride_kv,
                                upsample_q=upsample, fused=True)
    params = jmvit.multiscale_block_init(jax.random.PRNGKey(seed), jspec)
    block = tmvit.MultiScaleBlock(tmvit.AttentionSpec(**dataclasses.asdict(jspec)))
    sd = {}
    _block(sd, "b", jax.tree_util.tree_map(np.asarray, params), upsample=upsample)
    block.load_state_dict({k[2:]: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()}, strict=True)
    return jspec, params, block.eval()


def _port(block, x, thw, route):
    """The port's block forward on the CPU; asserts it took ``route``."""
    assert tmvit.block_route(block.spec, None, thw) == route
    with torch.no_grad():
        out, out_thw = block(torch.from_numpy(np.asarray(x)), thw)
        ref, ref_thw = block.forward_composite(torch.from_numpy(np.asarray(x)), thw)
    assert out_thw == ref_thw
    # the plain twin against the port's own K1+K2 composite of the same block
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    return out.numpy(), out_thw


# (dim, dim_out, heads, thw, stride_kv): v0/a0-like (96→192, one head) and
# v2-like (192→384, two heads) at reduced grids
B3_CASES = [
    (96, 192, 1, (2, 16, 16), (1, 4, 4)),
    (192, 384, 2, (1, 16, 16), (1, 2, 2)),
]


@pytest.mark.parametrize("dim,dim_out,heads,thw,skv", B3_CASES)
def test_fused_block_matches_pallas(dim, dim_out, heads, thw, skv):
    jspec, params, block = _pair(dim, dim_out, heads, (), skv, seed=1)
    x = np.random.default_rng(1).standard_normal((2, int(np.prod(thw)), dim)).astype(np.float32)
    k, v = jmvit._pooled_kv(params, jspec, jnp.asarray(x), thw)
    want = jkb.fused_block(jnp.asarray(x), k, v, params, jspec, interpret=True, variant="loop")
    got, _ = _port(block, x, thw, "block")
    np.testing.assert_allclose(got, np.asarray(want), atol=3e-5, rtol=1e-4)


POOL_CASES = [  # tests/test_fused_block.py POOL_CASES
    (192, 192, 2, (4, 16, 32), (1, 4, 4)),
    (192, 384, 2, (4, 16, 32), (1, 4, 4)),
    (384, 384, 4, (4, 16, 32), (1, 2, 2)),
]


def _jax_pool(jspec, params, x, thw):
    r_out = jkb._pool_tile_plan(jspec, thw)[0]
    xj = jnp.asarray(x)
    k, v = jmvit._pooled_kv(params, jspec, xj, thw)
    q6 = jmvit._pool_q_slots(params, jspec, xj, thw, r_out)
    pad = tuple(int(kk // 2) for kk in jspec.skip_kernel)
    skip, _ = jmvit.pool_tokens_max(xj, thw, jspec.skip_kernel, jspec.stride_q, pad)
    return jkb.fused_pool_block(q6, skip, k, v, params, jspec, thw, interpret=True)


@pytest.mark.parametrize("dim,dim_out,heads,thw,skv", POOL_CASES)
def test_fused_pool_block_matches_pallas(dim, dim_out, heads, thw, skv):
    jspec, params, block = _pair(dim, dim_out, heads, (1, 2, 2), skv, seed=9)
    x = (np.random.default_rng(9).standard_normal((1, int(np.prod(thw)), dim)) * 0.5
         ).astype(np.float32)
    got, got_thw = _port(block, x, thw, "pool_block")
    assert got_thw == (thw[0], thw[1] // 2, thw[2] // 2)
    np.testing.assert_allclose(got, np.asarray(_jax_pool(jspec, params, x, thw)),
                               atol=5e-5, rtol=1e-4)


def test_fused_pool_block_negative_inputs():
    """All-negative activations: MaxPool's padding must never win the skip."""
    thw = (4, 16, 32)
    jspec, params, block = _pair(192, 192, 2, (1, 2, 2), (1, 4, 4), seed=10)
    x = (-1.0 - np.abs(np.random.default_rng(10).standard_normal((1, 2048, 192)))
         ).astype(np.float32)
    got, _ = _port(block, x, thw, "pool_block")
    np.testing.assert_allclose(got, np.asarray(_jax_pool(jspec, params, x, thw)),
                               atol=5e-5, rtol=1e-4)


DEC_CASES = [  # (dim, dim_out, heads, thw, stride_q, stride_kv)
    (768, 384, 4, (2, 8, 8), (1, 2, 2), (1, 2, 2)),    # decoder[1]-like, head dim 192
    (192, 96, 2, (4, 8, 16), (2, 1, 1), (1, 4, 4)),    # stride (2,1,1), decoder[3]-like
    (192, 96, 2, (3, 8, 16), (1, 2, 2), (1, 4, 4)),    # odd coarse T
]


@pytest.mark.parametrize("dim,dim_out,heads,thw,sq,skv", DEC_CASES)
def test_fused_decoder_block_matches_pallas(dim, dim_out, heads, thw, sq, skv):
    jspec, params, block = _pair(dim, dim_out, heads, sq, skv, upsample=True, seed=7)
    x = (np.random.default_rng(7).standard_normal((1, int(np.prod(thw)), dim)) * 0.5
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


# --- the dispatch map --------------------------------------------------------------

# flagship blocks -> kernel (0-based indices; everything else is composite)
FLAGSHIP_MAP = {
    ("video", 0): "block", ("audio", 0): "block", ("video", 2): "block",
    ("video", 1): "pool_block", ("audio", 1): "pool_block",
    ("video", 3): "pool_block", ("audio", 2): "pool_block",
    ("decoder", 1): "decoder_block", ("decoder", 2): "decoder_block",
    ("decoder", 3): "decoder_block",
}


def _walk(blocks, thw, decide):
    out = []
    for spec in blocks:
        out.append(decide(spec, thw))
        if spec.upsample_q:
            thw = tmvit._static_upsample_out(thw, spec.kernel_q, spec.stride_q, spec.padding_q,
                                             spec.output_padding_q)
        elif spec.pool_q_on:
            thw = tmvit._static_pool_out(thw, spec.kernel_q, spec.stride_q, spec.padding_q)
    return out


def _routes(spec, decide):
    return {
        "video": _walk(spec.video_blocks, spec.patch_dims, decide),
        "audio": _walk(spec.audio_blocks, spec.audio_patch_dims, decide),
        "decoder": _walk(spec.decoder_blocks, spec.fusion_thw, decide),
    }


def _jax_decide(spec, thw):
    """The JAX package's dispatch (csts_tpu/models/mvit.py:640-703) with its kernels on."""
    if (jkb.eligible(spec, None, True) and spec.dim <= 768 and int(np.prod(thw)) % 128 == 0):
        return "block"
    lk = tmvit._lk(spec, thw)
    if spec.upsample_q and spec.pool_q_on:
        thw_f = jmvit._static_upsample_out(thw, spec.kernel_q, spec.stride_q, spec.padding_q,
                                           spec.output_padding_q)
        if jkb.decoder_eligible(spec, None, True, thw_f, lk):
            return "decoder_block"
    if (not spec.upsample_q and spec.pool_q_on
            and jkb.pool_block_eligible(spec, None, True, thw, lk)):
        return "pool_block"
    return "composite"


def _port_decide(spec, thw):
    return tmvit.block_route(spec, None, thw)


def test_flagship_dispatch_map():
    tspec = tcsts.build_spec(presets.flagship_cfg())
    routes = _routes(tspec, _port_decide)
    got = {(kind, i): r for kind, rs in routes.items() for i, r in enumerate(rs)
           if r != "composite"}
    assert got == FLAGSHIP_MAP
    # the fusion blocks (in-frame mask, 8 heads) stay on K1+K2
    assert tmvit.block_route(tspec.spatial_fusion, torch.zeros(1), tspec.fusion_thw) == "composite"
    assert tmvit.block_route(tspec.temporal_fusion, None, (2, 2, 2)) == "composite"
    # the JAX package's own predicates give the same map on the same spec
    assert _routes(jcsts.build_spec(graft._flagship_cfg()), _jax_decide) == routes


@pytest.mark.parametrize("crop", [32, 64])
def test_small_cfg_dispatch_covers_jax(crop):
    """Where the JAX package runs a whole-block kernel the port does too; the
    port takes more blocks only because it drops the TPU's alignment guards."""
    jcfg, tcfg = graft._small_cfg(2), presets.small_cfg(2)
    for c in (jcfg, tcfg):
        c.DATA.TRAIN_CROP_SIZE = c.DATA.TEST_CROP_SIZE = crop
    port = _routes(tcsts.build_spec(tcfg), _port_decide)
    jax_ = _routes(jcsts.build_spec(jcfg), _jax_decide)
    for kind in port:
        for p, j in zip(port[kind], jax_[kind]):
            assert j == "composite" or p == j


@pytest.mark.parametrize("crop", [32, 64])
def test_small_cfg_forward_reaches_every_block_kernel(crop, monkeypatch):
    """The reduced model's CPU forward goes through B3, B4 and B5 (its
    parity with ``csts_apply`` is tests/test_torch_model.py's)."""
    cfg = presets.small_cfg(1)
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = crop
    model = tcsts.CSTS(tcsts.build_spec(cfg)).eval()
    calls = {}
    for name in ("fused_block", "fused_pool_block", "fused_decoder_block"):
        orig = getattr(kb, name)

        def spy(*args, _name=name, _orig=orig):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*args)
        monkeypatch.setattr(kb, name, spy)
    rng = np.random.default_rng(0)
    video = torch.from_numpy(rng.standard_normal((1, 8, crop, crop, 3)).astype(np.float32))
    audio = torch.from_numpy(rng.standard_normal((1, 8, 32, 32, 1)).astype(np.float32))
    with torch.no_grad():
        out = model(video, audio)
    assert bool(torch.isfinite(out).all())
    assert calls == {"fused_block": 2, "fused_pool_block": 6, "fused_decoder_block": 4}


def test_jax_kernels_stay_off_on_cpu():
    """The JAX reference of tests/test_torch_model.py is its composite on the
    CPU, so the port's block kernels are held against the composite there."""
    assert not jka.enabled()

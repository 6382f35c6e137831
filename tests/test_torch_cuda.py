"""The CUDA kernels against their plain versions on the card, at ragged shapes
the flagship forward does not reach (``chip_smoke.py`` covers the flagship's
own): partial query and key tiles, head views with strides, head dims 64 and
128, output widths and hidden widths that leave partial weight tiles; for the
whole-block kernels B3-B5, token counts that are no multiple of the tile, H
and W that are no multiple of the row tile, T of 1 and 3, Lk of 64, 256 and
1024; K1 with its keys split (against the plain model of the split too),
with blocks that walk several query tiles, and with the mask in bf16 and
fp32, the log-sum-exp rows on and off; B9a at ragged planes and channels (one channel a thread or 16 bytes);
the whole-block kernel at 3, 4 and 8 heads (B9b/B9c) at L 1000 and Lk 200;
for the training kernels B7 (forward and its hand-written backward)
and B8, ragged rows and keys, a zero stochastic-depth factor, strided output
gradients, and the three autograd Functions against autograd of their plain
versions; K1, K2 and B3 under autograd through their wrappers (the Functions
of the JAX package's custom VJPs), B4 and B5 refusing a gradient
("inference-only"); ``small_cfg``'s eval loop
(``csts_torch.eval.tester.test``: loader, prefetcher, metrics) through the
kernels against the same loop through the plain twins, and the AUC's
tie order on the card against the CPU's; the orbax checkpointer's round
trip on CUDA tensors; ``small_cfg``'s step on two gloo
ranks sharing the card (DDP, the kernels in each rank) against one process,
and what NCCL and gloo do with two ranks on one card.

They skip without a card. On one, run them without the JAX suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

or under ``compute-sanitizer --tool memcheck python -m pytest ...`` to check
every kernel's memory accesses.
"""

import contextlib
import os

import pytest
import torch

from chip_smoke import (B7_BWD_BAR, B7_BWD_VECTOR_BAR, B8_BAR, FP32_ATOL, FP32_RTOL, bf16_bar,
                        rel_err, split_bar)
from csts_torch.kernels import attention as ka
from csts_torch.kernels import block as kb
from csts_torch.kernels import upsample as kup
from csts_torch.models.mvit import build_inframe_mask
from csts_torch.ops import layer_norm

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def _ln1(args):
    """B3's xn: LN1 of its x in x's dtype, as the block's phase 1 gives it."""
    return layer_norm(args[0], args[4], args[5])


def _check(name, kernel, plain, args, keep=()):
    """Kernel vs plain version in fp32 and in bf16, at the bars of chip_smoke.
    Arguments at the indices in ``keep`` stay as they are (the fp32 mask).
    B3 ("block") is also given LN1(x) in each dtype, as the block gives it."""
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            cast = [a.to(dtype) if isinstance(a, torch.Tensor) and i not in keep else a
                    for i, a in enumerate(args)]
            if name == "block":
                cast.append(_ln1(cast))
            before = kernel.launches
            got = kernel(*cast)
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
            want = plain(*cast)
            err = float((got.float() - want.float()).abs().max())
            bar = (FP32_ATOL[name] + FP32_RTOL[name] * float(want.abs().max())
                   if dtype == torch.float32 else bf16_bar(name, want))
            assert got.shape == want.shape and got.dtype == dtype
            assert err <= bar, (name, dtype, err, bar)


@pytest.mark.parametrize("b,n,lq,lk,hd,masked,fused_qkv", [
    (2, 3, 100, 70, 64, False, False),
    (1, 2, 33, 130, 128, False, False),
    (1, 2, 65, 1024, 192, False, False),
    (2, 4, 77, 77, 96, False, True),    # head views of one (B, L, 3, N, hd) projection
    (1, 2, 260, 260, 96, True, False),  # the spatial fusion's mask
])
def test_attention_ragged(gen, b, n, lq, lk, hd, masked, fused_qkv):
    if fused_qkv:
        qkv = _randn(gen, b, lq, 3, n, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
    else:
        q, k, v = _randn(gen, b, n, lq, hd), _randn(gen, b, n, lk, hd), _randn(gen, b, n, lk, hd)
    mask = torch.from_numpy(build_inframe_mask((4, 8, 8), 4)).cuda() if masked else None
    _check("attention", ka.fused_attention, ka.fused_attention_plain,
           [q, k, v, hd ** -0.5, mask], keep=(4,))


@pytest.mark.parametrize("b,n,lq,lk", [
    (1, 2, 256, 1024),   # the Q-pool shape (v14, a3) at batch 1: four key splits
    (1, 2, 100, 1000),   # ragged keys: the last chunk and the last split short
])
def test_attention_key_split(gen, b, n, lq, lk):
    """K1's bf16 body with the keys split: against the plain version (both
    dtypes) and, in bf16, against the plain model of the split and merge."""
    hd = 96
    q, k, v = _randn(gen, b, n, lq, hd), _randn(gen, b, n, lk, hd), _randn(gen, b, n, lk, hd)
    splits = ka.key_splits(b * n, lq, lk, torch.cuda.get_device_properties(0).multi_processor_count)
    assert splits > 1
    _check("attention", ka.fused_attention, ka.fused_attention_plain, [q, k, v, hd ** -0.5])
    with torch.inference_mode():
        q16, k16, v16 = q.bfloat16(), k.bfloat16(), v.bfloat16()
        got = ka.fused_attention(q16, k16, v16, hd ** -0.5)
        want = ka.fused_attention_split_plain(q16, k16, v16, hd ** -0.5, splits)
        err = float((got.float() - want.float()).abs().max())
        assert err <= split_bar(want), err


@pytest.mark.parametrize("lq,hd,tpb,masked", [
    (333, 96, 2, False),    # two Q buffers, a ragged last tile
    (333, 96, 3, False),
    (333, 192, 2, False),   # one Q buffer (head dim 192)
    (260, 96, 2, True),     # the masked site's shape
])
def test_attention_query_tiles_per_block(gen, monkeypatch, lq, hd, tpb, masked):
    """K1's bf16 body with blocks that walk several query tiles (the policy
    set to ``tpb`` at these small grids)."""
    monkeypatch.setattr(ka, "query_tiles_per_block", lambda *_: tpb)
    lk = lq if masked else 200
    q, k, v = _randn(gen, 2, 2, lq, hd), _randn(gen, 2, 2, lk, hd), _randn(gen, 2, 2, lk, hd)
    mask = (torch.from_numpy(build_inframe_mask((4, 8, 8), 4)).cuda().bfloat16()
            if masked else None)
    with torch.inference_mode():
        q16, k16, v16 = q.bfloat16(), k.bfloat16(), v.bfloat16()
        got, lse = ka._attention_fwd(q16, k16, v16, hd ** -0.5, mask, True)
        want = ka.fused_attention_plain(q16, k16, v16, hd ** -0.5, mask)
        assert float((got.float() - want.float()).abs().max()) <= bf16_bar("attention", want)
        logits = torch.matmul(q16.float(), k16.float().transpose(-1, -2)) * hd ** -0.5
        if mask is not None:
            logits = logits + mask.float()
        ref = torch.logsumexp(logits, dim=-1).reshape(-1, lq)
        assert float((lse - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("mask_dtype", [None, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_lse", [False, True])
def test_attention_mask_dtype_and_lse(gen, mask_dtype, with_lse):
    """The bf16 body reads the mask in its own dtype (bf16 or fp32) and writes
    the log-sum-exp rows when asked, masked or not."""
    b, n, lq, lk, hd = 1, 2, 260, 260, 96
    q, k, v = (_randn(gen, b, n, l, hd).bfloat16() for l in (lq, lk, lk))
    mask = None
    if mask_dtype is not None:
        mask = torch.from_numpy(build_inframe_mask((4, 8, 8), 4)).cuda().to(mask_dtype)
    with torch.inference_mode():
        out, lse = ka._attention_fwd(q, k, v, hd ** -0.5, mask, with_lse=with_lse)
        want = ka.fused_attention_plain(q, k, v, hd ** -0.5, mask)
        assert float((out.float() - want.float()).abs().max()) <= bf16_bar("attention", want)
        if not with_lse:
            assert lse is None
            return
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
        if mask is not None:
            logits = logits + mask.float()
        ref = torch.logsumexp(logits, dim=-1).reshape(b * n, lq)
        assert lse.shape == (b * n, lq) and lse.dtype == torch.float32
        assert float((lse - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("m,c,h,cout,proj", [
    (100, 96, 400, 112, True),     # partial output tile and partial hidden chunk
    (70, 160, 640, 160, False),    # partial fc1 tile along the input width
    (33, 384, 1536, 192, True),
    (300, 768, 3072, 768, False),  # two output tiles
])
def test_mlp_tail_ragged(gen, m, c, h, cout, proj):
    args = [_randn(gen, 2, m, c), 1 + _randn(gen, c, scale=0.1), _randn(gen, c, scale=0.1),
            _randn(gen, h, c, scale=c ** -0.5), _randn(gen, h, scale=0.1),
            _randn(gen, cout, h, scale=h ** -0.5), _randn(gen, cout, scale=0.1)]
    if proj:
        args += [_randn(gen, cout, c, scale=c ** -0.5), _randn(gen, cout, scale=0.1)]
    _check("mlp_tail", kb.fused_mlp_tail, kb.fused_mlp_tail_plain, args)


@pytest.mark.parametrize("b,thw,c", [(2, (3, 5, 7), 24), (1, (1, 4, 4), 3), (2, (4, 8, 8), 1)])
def test_t2_upsample_ragged(gen, b, thw, c):
    x = _randn(gen, b, thw[0] * thw[1] * thw[2], c)
    _check("t2_upsample", kup.t2_upsample, kup.t2_upsample_plain, [x, thw])


@pytest.mark.parametrize("b,thw,c", [
    (2, (3, 5, 7), 24),    # 16 bytes of channels a thread in bf16 and fp32
    (1, (2, 3, 3), 3),     # one channel a thread
    (2, (1, 9, 4), 100),   # fp32 16 bytes a thread, bf16 one channel
    (1, (2, 1, 1), 136),   # a 1x1 plane: every tap clamped
])
def test_hw2_upsample_ragged(gen, b, thw, c):
    """B9a at ragged H and W and C no multiple of 128, at K3's bars."""
    x = _randn(gen, b, thw[0] * thw[1] * thw[2], c)
    _check("t2_upsample", kup.hw2_upsample, kup.hw2_upsample_plain, [x, thw])


def _tail(gen, c, cout, hidden):
    """wproj, bproj, LN2, fc1, fc2 and (when c != cout) the dim-change proj."""
    w = [_randn(gen, c, c, scale=c ** -0.5), _randn(gen, c, scale=0.1),
         1 + _randn(gen, c, scale=0.1), _randn(gen, c, scale=0.1),
         _randn(gen, hidden, c, scale=c ** -0.5), _randn(gen, hidden, scale=0.1),
         _randn(gen, cout, hidden, scale=hidden ** -0.5), _randn(gen, cout, scale=0.1)]
    if c != cout:
        return w + [_randn(gen, cout, c, scale=c ** -0.5), _randn(gen, cout, scale=0.1)]
    return w + [None, None]


def _kv(gen, b, n, lk, hd):
    return _randn(gen, b, n, lk, hd), _randn(gen, b, n, lk, hd)


@pytest.mark.parametrize("b,l,c,cout,heads,lk", [
    (2, 100, 96, 192, 1, 64),     # partial token tile, one head
    (1, 333, 192, 384, 2, 256),   # two heads, a partial tile of 64
    (1, 70, 192, 192, 2, 1024),   # identity base
])
def test_block_ragged(gen, b, l, c, cout, heads, lk):
    hd = c // heads
    k, v = _kv(gen, b, heads, lk, hd)
    args = [_randn(gen, b, l, c), k, v, hd ** -0.5, 1 + _randn(gen, c, scale=0.1),
            _randn(gen, c, scale=0.1), _randn(gen, c, c, scale=c ** -0.5),
            _randn(gen, c, scale=0.1)] + _tail(gen, c, cout, 4 * c)
    _check("block", kb.fused_block, kb.fused_block_plain, args)


@pytest.mark.parametrize("b,l,c,cout,heads,lk", [
    (1, 1000, 288, 288, 3, 200),   # three heads, ragged tokens and keys
    (2, 1000, 384, 384, 4, 200),
    (1, 1000, 384, 768, 4, 200),   # the widening: two output column tiles
    (2, 1000, 768, 768, 8, 200),   # eight heads, the d768 instance
])
def test_block_multihead_ragged(gen, b, l, c, cout, heads, lk):
    """The whole-block kernel at 3-8 heads (B9b/B9c) at B3's bars."""
    hd = c // heads
    k, v = _kv(gen, b, heads, lk, hd)
    args = [_randn(gen, b, l, c), k, v, hd ** -0.5, 1 + _randn(gen, c, scale=0.1),
            _randn(gen, c, scale=0.1), _randn(gen, c, c, scale=c ** -0.5),
            _randn(gen, c, scale=0.1)] + _tail(gen, c, cout, 4 * c)
    _check("block", kb.fused_block, kb.fused_block_plain, args)


def _q_source(gen, b, l, c):
    """The Q columns of a fused (B, L, 3C) projection: a strided view."""
    return _randn(gen, b, l, 3 * c)[..., :c]


@pytest.mark.parametrize("b,thw,c,cout,heads,lk", [
    (2, (1, 8, 8), 192, 384, 2, 64),       # T 1
    (1, (3, 10, 14), 192, 192, 2, 1024),   # T 3, coarse rows 5 x 7
    (1, (2, 16, 16), 384, 768, 4, 256),    # two output column tiles
])
def test_pool_block_ragged(gen, b, thw, c, cout, heads, lk):
    hd = c // heads
    t, h, w = thw
    l_out = t * ((h + 1) // 2) * ((w + 1) // 2)
    k, v = _kv(gen, b, heads, lk, hd)
    args = [_q_source(gen, b, t * h * w, c), thw, _randn(gen, b, l_out, c), k, v, hd ** -0.5,
            _randn(gen, hd, 1, 3, 3, 3, scale=0.2), 1 + _randn(gen, hd, scale=0.1),
            _randn(gen, hd, scale=0.1)] + _tail(gen, c, cout, 4 * c)
    _check("pool_block", kb.fused_pool_block, kb.fused_pool_block_plain, args)


@pytest.mark.parametrize("b,thw,stride,c,cout,heads,lk", [
    (1, (1, 4, 6), (1, 2, 2), 768, 384, 4, 64),   # head dim 192, 32-token tiles
    (2, (3, 5, 7), (2, 1, 1), 192, 96, 2, 64),    # odd coarse T, partial tiles
    (1, (3, 3, 5), (1, 2, 2), 384, 192, 4, 256),
    (2, (2, 5, 7), (1, 2, 2), 768, 384, 4, 64),    # d2 geometry, 280 rows: a partial 64-row tile
    (1, (3, 6, 10), (2, 1, 1), 384, 192, 4, 64),   # d3 widths at stride (2,1,1), 360 rows
    (2, (2, 5, 7), (1, 2, 2), 768, 384, 8, 64),    # d2 widths at eight heads of 96
    (1, (2, 4, 6), (1, 2, 2), 768, 384, 6, 64),    # head dim 128: the first design's body
])
def test_decoder_block_ragged(gen, b, thw, stride, c, cout, heads, lk):
    _check("decoder_block", kb.fused_decoder_block, kb.fused_decoder_block_plain,
           _decoder_args(gen, b, thw, stride, c, cout, heads, lk))


def _decoder_args(gen, b, thw, stride, c, cout, heads, lk):
    hd = c // heads
    t, h, w = thw
    l_out = t * h * w * stride[0] * stride[1] * stride[2]
    k, v = _kv(gen, b, heads, lk, hd)
    return [_q_source(gen, b, t * h * w, c), thw, stride, _randn(gen, b, l_out, c), k, v,
            hd ** -0.5, _randn(gen, hd, 1, 3, 3, 3, scale=0.2), 1 + _randn(gen, hd, scale=0.1),
            _randn(gen, hd, scale=0.1)] + _tail(gen, c, cout, 4 * cout)


def test_decoder_block_scratch_held(gen):
    """B5's bf16 body parks q, av and res1 in scratch buffers between its
    three launches. At ragged L with two clips, twice with other allocations
    in between, each call must match the plain version and the other call:
    a scratch buffer handed to another of the launches would not."""
    args = [a.bfloat16() if isinstance(a, torch.Tensor) else a
            for a in _decoder_args(gen, 2, (2, 5, 7), (1, 2, 2), 768, 384, 4, 64)]
    with torch.inference_mode():
        first = kb.fused_decoder_block(*args)
        churn = [torch.empty(2 * 288 * 768 * n, dtype=torch.bfloat16, device="cuda")
                 for n in (1, 2, 4)]
        second = kb.fused_decoder_block(*args)
        del churn
        torch.cuda.synchronize()
        want = kb.fused_decoder_block_plain(*args)
        for got in (first, second):
            assert float((got.float() - want.float()).abs().max()) <= bf16_bar("decoder_block", want)
        assert torch.equal(first, second)


def test_kernels_refuse_gradients(gen):
    """The kernels without a backward launch outside autograd: an input that
    wants a gradient is refused, "inference-only" as in the JAX package
    (the eval K3 and B9a, B7's raw forward, whose Function takes it; B4 and
    B5 in ``test_pool_and_decoder_blocks_are_inference_only``). K1, K2 and
    B3 differentiate instead (``test_k1_k2_b3_differentiate``)."""
    x = _randn(gen, 1, 8, 16).requires_grad_()
    with pytest.raises(RuntimeError, match="inference-only"):
        kup.t2_upsample(x, (2, 2, 2))
    with pytest.raises(RuntimeError, match="inference-only"):
        kup.hw2_upsample(x, (2, 2, 2))
    x = _randn(gen, 2, 8, 16).requires_grad_()
    w = _randn(gen, 16)
    with pytest.raises(RuntimeError, match="inference-only"):
        kb.fused_mlp_tail_train(x, w, w, _randn(gen, 64, 16), _randn(gen, 64),
                                _randn(gen, 16, 64), w, None, None,
                                torch.ones(2, device="cuda"))


def test_pool_and_decoder_blocks_are_inference_only(gen):
    """B4 and B5 refuse an input that wants a gradient on the card before
    any launch, as the JAX package's raise "inference-only"."""
    b, thw, c, heads, lk = 1, (2, 8, 8), 96, 1, 64
    hd = c // heads
    k, v = _kv(gen, b, heads, lk, hd)
    q = _randn(gen, b, 128, c).requires_grad_()
    conv = [_randn(gen, hd, 1, 3, 3, 3, scale=0.2), 1 + _randn(gen, hd, scale=0.1),
            _randn(gen, hd, scale=0.1)]
    before = (kb.fused_pool_block.launches, kb.fused_decoder_block.launches)
    with pytest.raises(RuntimeError, match="inference-only"):
        kb.fused_pool_block(q, thw, _randn(gen, b, 32, c), k, v, hd ** -0.5, *conv,
                            *_tail(gen, c, c, 4 * c))
    with pytest.raises(RuntimeError, match="inference-only"):
        kb.fused_decoder_block(q, thw, (1, 2, 2), _randn(gen, b, 512, c), k, v, hd ** -0.5,
                               *conv, *_tail(gen, c, c, 4 * c))
    assert (kb.fused_pool_block.launches, kb.fused_decoder_block.launches) == before


@pytest.mark.parametrize("name", ["attention", "attention_masked", "mlp_tail", "block"])
def test_k1_k2_b3_differentiate(gen, name):
    """K1, K2 and B3 under autograd on the card through their wrappers
    (``FusedAttention``: K1 forward, B8 backward or the masked recompute;
    ``MlpTail`` and ``FusedBlock``: the kernel forward, the recompute of the
    plain twin backward), fp32 at ragged shapes, against autograd of the
    plain twins at chip_smoke's phase 5b bars (``GRAD_BARS``); each kernel's
    launches move once."""
    from chip_smoke import GRAD_BARS

    b, l, c, cout, heads, lk = 2, 100, 96, 192, 1, 64
    if name.startswith("attention"):
        q, k, v = _randn(gen, b, 2, 68, 64), _randn(gen, b, 2, 68, 64), _randn(gen, b, 2, 68, 64)
        mask = (torch.from_numpy(build_inframe_mask((4, 4, 4), 4)).cuda()
                if name == "attention_masked" else None)
        args, wrt, fn, plain, counter = ([q, k, v, 0.125, mask], [0, 1, 2], ka.fused_attention,
                                         ka.fused_attention_plain, ka.fused_attention)
    elif name == "mlp_tail":
        args = [_randn(gen, b, l, c)] + _tail(gen, c, cout, 4 * c)[2:]
        wrt, fn, plain, counter = list(range(len(args))), kb.fused_mlp_tail, \
            kb.fused_mlp_tail_plain, kb.fused_mlp_tail
    else:
        hd = c // heads
        k, v = _kv(gen, b, heads, lk, hd)
        args = [_randn(gen, b, l, c), k, v, hd ** -0.5, 1 + _randn(gen, c, scale=0.1),
                _randn(gen, c, scale=0.1), _randn(gen, c, c, scale=c ** -0.5),
                _randn(gen, c, scale=0.1)] + _tail(gen, c, cout, 4 * c)
        wrt = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        fn, plain, counter = kb.fused_block, kb.fused_block_plain, kb.fused_block
    atol, rtol = GRAD_BARS["attention" if name.startswith("attention") else name]

    def grads(f):
        leaves = [a.detach().requires_grad_(i in wrt) if isinstance(a, torch.Tensor) else a
                  for i, a in enumerate(args)]
        out = f(*leaves)
        g = torch.linspace(-1, 1, out.numel(), device="cuda").reshape(out.shape)
        return out, torch.autograd.grad(out, [leaves[i] for i in wrt], g)

    before, bwd = counter.launches, ka.fused_attention_bwd.launches
    out, got = grads(fn)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert ka.fused_attention_bwd.launches == bwd + (name == "attention")
    ref_out, ref = grads(plain)
    key = "attention" if name.startswith("attention") else name
    bar = FP32_ATOL[key] + FP32_RTOL[key] * float(ref_out.abs().max())
    assert float((out - ref_out).abs().max()) <= bar
    for a, r in zip(got, ref):
        assert bool(((a - r).abs() <= atol + rtol * r.abs()).all())


def _tail_args(gen, b, l, c, cout, hidden):
    """x, then LN2, fc1, fc2 and the dim-change proj (None, None when c == cout)."""
    return [_randn(gen, b, l, c)] + _tail(gen, c, cout, hidden)[2:]


@pytest.mark.parametrize("b,l,c,cout,hidden", [
    (3, 100, 96, 96, 384),      # ragged rows, identity base
    (2, 130, 96, 192, 384),     # proj base, partial row tile
    (2, 70, 384, 192, 768),     # decoder-style hidden 4·dim_out
    (1, 260, 768, 768, 3072),   # two output tiles (fc1 twice, hidden written once)
])
def test_mlp_tail_train_ragged(gen, b, l, c, cout, hidden):
    """B7 forward: out and the stored hidden against the plain version, with
    one sample's MLP branch dropped (dp 0) and the others scaled."""
    args = _tail_args(gen, b, l, c, cout, hidden)
    dp = torch.full((b,), 1.25, device="cuda")
    dp[0] = 0.0
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            cast = [a.to(dtype) if a is not None else None for a in args]
            before = kb.fused_mlp_tail_train.launches
            out, hid = kb.fused_mlp_tail_train(*cast, dp)
            torch.cuda.synchronize()
            assert kb.fused_mlp_tail_train.launches == before + 1
            want_out, want_hid = kb.fused_mlp_tail_train_plain(*cast, dp)
            for got, want in ((out, want_out), (hid, want_hid)):
                assert got.shape == want.shape and got.dtype == dtype
                err = float((got.float() - want.float()).abs().max())
                bar = (FP32_ATOL["mlp_tail"] + FP32_RTOL["mlp_tail"] * float(want.abs().max())
                       if dtype == torch.float32 else bf16_bar("mlp_tail", want))
                assert err <= bar, (dtype, err, bar)


def _lse(q, k, v, scale):
    return ka._attention_fwd(q, k, v, scale, None, with_lse=True)


@pytest.mark.parametrize("b,n,lq,lk,hd,strided_g", [
    (2, 4, 100, 8, 96, False),     # Lk 8: one key chunk, mostly past Lk
    (2, 2, 300, 64, 192, True),    # head dim 192 (split in two), strided g
    (1, 2, 128, 250, 96, True),    # ragged keys over four chunks
    (1, 1, 5000, 64, 96, False),   # many query tiles: chunked dk/dv with the reduction
])
def test_attention_bwd_ragged(gen, b, n, lq, lk, hd, strided_g):
    """B8 against its plain version from the same (q, k, v, out, g), out and
    lse from K1. fp32 and bf16 bars in chip_smoke.B8_BAR."""
    scale = hd ** -0.5
    q, k, v = _randn(gen, b, n, lq, hd), _randn(gen, b, n, lk, hd), _randn(gen, b, n, lk, hd)
    g = _randn(gen, b, lq, n, hd).permute(0, 2, 1, 3) if strided_g else _randn(gen, b, n, lq, hd)
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            qc, kc, vc, gc = (t.to(dtype) for t in (q, k, v, g))
            out, lse = _lse(qc, kc, vc, scale)
            before = ka.fused_attention_bwd.launches
            got = ka.fused_attention_bwd(qc, kc, vc, out, gc, scale, lse)
            torch.cuda.synchronize()
            assert ka.fused_attention_bwd.launches == before + 1
            want = ka.fused_attention_bwd_plain(qc, kc, vc, out, gc, scale)
            for name, x, y in zip(("dq", "dk", "dv"), got, want):
                assert x.shape == y.shape and x.dtype == dtype
                err = float((x.float() - y.float()).abs().max())
                bar = B8_BAR[dtype] * max(1.0, float(y.float().abs().max()))
                assert err <= bar, (name, dtype, err, bar)


def test_attention_train_function_matches_autograd_of_plain(gen):
    """K1 forward + B8 backward through the Function against autograd of the
    plain attention, fp32, unmasked and masked."""
    mask = torch.from_numpy(build_inframe_mask((4, 8, 8), 4)).cuda()
    for lq, lk, m in ((200, 64, None), (260, 260, mask)):
        q, k, v = (_randn(gen, 2, 2, n_, 96).requires_grad_() for n_ in (lq, lk, lk))
        g = _randn(gen, 2, 2, lq, 96)
        got = torch.autograd.grad(ka.attention_train(q, k, v, 96 ** -0.5, m), (q, k, v), g)
        want = torch.autograd.grad(ka.fused_attention_plain(q, k, v, 96 ** -0.5, m), (q, k, v), g)
        for x, y in zip(got, want):
            assert rel_err(x, y) <= 1e-5, rel_err(x, y)


@pytest.mark.parametrize("c,cout", [(96, 96), (96, 192)])
def test_mlp_tail_train_function_matches_autograd_of_plain(gen, c, cout):
    """B7 forward + the hand-written backward against autograd of the plain
    version: x and every weight, fp32 and bf16 (chip_smoke's B7_BWD_BAR and
    B7_BWD_VECTOR_BAR)."""
    args = _tail_args(gen, 2, 150, c, cout, 4 * c)
    dp = torch.tensor([0.0, 1.25], device="cuda")
    g = _randn(gen, 2, 150, cout)
    for dtype in (torch.float32, torch.bfloat16):
        leaves = [a.to(dtype).requires_grad_() if a is not None else None for a in args]
        ins = [t for t in leaves if t is not None]
        got = torch.autograd.grad(kb.mlp_tail_train(*leaves, dp), ins, g.to(dtype))
        want = torch.autograd.grad(kb.fused_mlp_tail_train_plain(*leaves, dp)[0], ins, g.to(dtype))
        for x, y in zip(got, want):
            bar = (B7_BWD_VECTOR_BAR if y.dim() == 1 else B7_BWD_BAR)[dtype]
            assert rel_err(x, y) <= bar, (dtype, rel_err(x, y), bar)


def test_t2_upsample_train_function_matches_autograd_of_plain(gen):
    x = _randn(gen, 2, 3 * 5 * 7, 24).requires_grad_()
    g = _randn(gen, 2, 6 * 5 * 7, 24)
    got, = torch.autograd.grad(kup.t2_upsample_train(x, (3, 5, 7)), x, g)
    want, = torch.autograd.grad(kup.t2_upsample_plain(x, (3, 5, 7)), x, g)
    assert rel_err(got, want) <= 1e-6


# ----------------------------------------------------------------------------------
# small_cfg on the card, K1 and B8 at padded head dims, the whole blocks at widths
# without an instance of their own, and K2 / B7 on their Hopper body
# ----------------------------------------------------------------------------------


def _small_model(batch):
    """small_cfg(batch)'s model (head dim 16, widths 16-128) with seeded
    random weights on the card, its config and spec, and its inputs."""
    import dataclasses

    import numpy as np

    from csts_torch.models.csts import CSTS, build_spec, init_params
    from csts_torch.presets import small_cfg

    cfg = small_cfg(batch)
    spec = build_spec(cfg)
    model = CSTS(dataclasses.replace(spec, dtype="float32"))
    init_params(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    t, s = spec.num_frames, spec.crop_size
    video = torch.from_numpy(rng.standard_normal((batch, t, s, s, 3), dtype=np.float32)).cuda()
    audio = torch.from_numpy(rng.standard_normal(
        (batch, t, cfg.DATA.AUDIO_FREQ_BINS, cfg.DATA.AUDIO_WINDOW, 1), dtype=np.float32)).cuda()
    return cfg, spec, model, video, audio


def test_small_cfg_forward_bf16_through_kernels(gen):
    """small_cfg(2)'s bf16 forward through the kernels (K1 at head dim 16,
    padded; B3, B4 and B5 at its widths; K2; K3) against the same weights
    through the plain twins in fp32: per-frame softmax within 0.02 and each
    frame's argmax within one pixel; the counters show every kernel ran."""
    import dataclasses

    from chip_smoke import WRAPPERS, reset_launches
    from csts_torch.models.csts import CSTS
    from csts_torch.tools import plain_twins
    from csts_torch.train.losses import frame_softmax

    cfg, spec, ref, video, audio = _small_model(2)
    model = CSTS(dataclasses.replace(spec, dtype="bfloat16"))
    model.load_state_dict(ref.state_dict())
    model = model.to(torch.bfloat16).cuda().eval()
    ref = ref.cuda().eval()
    with torch.inference_mode():
        reset_launches()
        logits16 = model(video, audio).float()
        torch.cuda.synchronize()
        ran = {n: WRAPPERS[n].launches for n in ("attention", "mlp_tail", "block", "pool_block",
                                                 "decoder_block", "t2_upsample")}
        with plain_twins():
            logits32 = ref(video, audio)
    assert all(ran.values()), ran
    sm16, sm32 = frame_softmax(logits16), frame_softmax(logits32)
    assert float((sm16 - sm32).abs().max()) < 0.02
    w = logits32.shape[3]
    a16 = logits16.reshape(*logits16.shape[:2], -1).argmax(-1)
    a32 = logits32.reshape(*logits32.shape[:2], -1).argmax(-1)
    assert int((a16 // w - a32 // w).abs().max()) <= 1 and int((a16 % w - a32 % w).abs().max()) <= 1


def test_small_cfg_train_step_fp32_through_kernels(gen):
    """One fp32 small_cfg(2) training step (TF32 off) through the kernels
    and through the plain twins from the same weights, masks and batch, at
    PERF.md §2's bars: the loss within 1e-5 relative, each gradient within
    1e-3 in relative norm plus 1e-6 of the whole gradient's norm."""
    import numpy as np

    from chip_smoke import (STEP_GRAD_FLOOR, STEP_GRAD_RTOL, STEP_LOSS_RTOL, WRAPPERS,
                            reset_launches)
    from csts_torch.tools import plain_twins
    from csts_torch.ops import sample_drop_masks
    from csts_torch.train import step as train_lib

    torch.backends.cudnn.allow_tf32 = False
    cfg, spec, model, video, audio = _small_model(2)
    model = model.cuda().train()
    hw = spec.crop_size // 4
    hm = torch.rand(2, spec.num_frames, hw, hw, generator=gen, device="cuda")
    batch = {"video": video, "audio": audio, "labels_hm": hm / hm.sum(dim=(2, 3), keepdim=True)}

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        drop = sample_drop_masks(spec.video_blocks, 2, torch.Generator().manual_seed(2), "cuda")
        loss, _, _ = train_lib.forward_loss(cfg, model, batch, drop)
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().clone() if p.grad is not None
                                      else torch.zeros_like(p) for n, p in model.named_parameters()}

    reset_launches()
    loss_k, grads_k = loss_and_grads()
    ran = {n: WRAPPERS[n].launches for n in ("attention", "attention_bwd", "mlp_tail_train",
                                             "t2_upsample")}
    assert all(ran.values()), ran
    with plain_twins():
        loss_p, grads_p = loss_and_grads()
    assert abs(loss_k - loss_p) <= STEP_LOSS_RTOL * abs(loss_p), (loss_k, loss_p)
    norm = lambda t: float(torch.linalg.vector_norm(t.float()))  # noqa: E731
    floor = STEP_GRAD_FLOOR * float(np.sqrt(sum(norm(g) ** 2 for g in grads_p.values())))
    for n in grads_p:
        assert norm(grads_k[n] - grads_p[n]) <= STEP_GRAD_RTOL * norm(grads_p[n]) + floor, n


@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("b,n,lq,lk", [(2, 2, 100, 70), (1, 8, 8, 8)])
def test_attention_small_head_dims(gen, hd, b, n, lq, lk):
    """K1 and B8 at head dims with no compiled instance (run zero-padded to
    64) against their plain twins at chip_smoke's bars; the counters move."""
    scale = hd ** -0.5
    q, k, v = _randn(gen, b, n, lq, hd), _randn(gen, b, n, lk, hd), _randn(gen, b, n, lk, hd)
    _check("attention", ka.fused_attention, ka.fused_attention_plain, [q, k, v, scale])
    g = _randn(gen, b, n, lq, hd)
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            qc, kc, vc, gc = (t.to(dtype) for t in (q, k, v, g))
            out, lse = _lse(qc, kc, vc, scale)
            assert out.shape == qc.shape
            before = ka.fused_attention_bwd.launches
            got = ka.fused_attention_bwd(qc, kc, vc, out, gc, scale, lse)
            torch.cuda.synchronize()
            assert ka.fused_attention_bwd.launches == before + 1
            want = ka.fused_attention_bwd_plain(qc, kc, vc, out, gc, scale)
            for name, x, y in zip(("dq", "dk", "dv"), got, want):
                assert x.shape == y.shape and x.dtype == dtype
                bar = B8_BAR[dtype] * max(1.0, float(y.float().abs().max()))
                assert float((x.float() - y.float()).abs().max()) <= bar, (name, dtype)


@pytest.mark.parametrize("kind,b,l,c,cout,heads", [
    ("block", 2, 100, 96, 384, 1),      # 96 -> 384: no instance of its own (the widest)
    ("block", 1, 150, 384, 192, 4),     # 384 -> 192 at four heads: the widest
    ("block", 1, 90, 512, 512, 2),      # head dim 256 at dim 512 (one row warp)
    ("block", 2, 256, 16, 32, 1),       # small_cfg's v0 / a0
    ("pool_block", 1, 0, 384, 192, 4),  # 384 -> 192: the widest
    ("pool_block", 1, 0, 640, 640, 5),  # dim 640 (one row warp), head dim 128
    ("pool_block", 2, 0, 64, 128, 4),   # small_cfg's v2
])
def test_whole_block_any_width(gen, kind, b, l, c, cout, heads):
    """B3 and B4 at widths block_route may send them that have no compiled
    instance of their own: the widest instance of their row split, chosen
    before the launch, at the kernels' bars."""
    hd = c // heads
    lk = 64
    k, v = _kv(gen, b, heads, lk, hd)
    if kind == "block":
        args = [_randn(gen, b, l, c), k, v, hd ** -0.5, 1 + _randn(gen, c, scale=0.1),
                _randn(gen, c, scale=0.1), _randn(gen, c, c, scale=c ** -0.5),
                _randn(gen, c, scale=0.1)] + _tail(gen, c, cout, 4 * c)
        _check("block", kb.fused_block, kb.fused_block_plain, args)
        return
    thw = (2, 9, 7)
    t, h, w = thw
    l_out = t * ((h + 1) // 2) * ((w + 1) // 2)
    args = [_q_source(gen, b, t * h * w, c), thw, _randn(gen, b, l_out, c), k, v, hd ** -0.5,
            _randn(gen, hd, 1, 3, 3, 3, scale=0.2), 1 + _randn(gen, hd, scale=0.1),
            _randn(gen, hd, scale=0.1)] + _tail(gen, c, cout, 4 * c)
    _check("pool_block", kb.fused_pool_block, kb.fused_pool_block_plain, args)


@pytest.mark.parametrize("thw,stride,c,cout,heads", [
    ((4, 1, 1), (1, 2, 2), 128, 128, 8),   # small_cfg's d1: identity base, head dim 16
    ((4, 4, 4), (1, 2, 2), 64, 32, 4),     # small_cfg's d3
    ((4, 8, 8), (2, 1, 1), 32, 16, 2),     # small_cfg's d4
])
def test_decoder_block_small_widths(gen, thw, stride, c, cout, heads):
    """B5's first design at small_cfg's widths (the widest instance)."""
    _check("decoder_block", kb.fused_decoder_block, kb.fused_decoder_block_plain,
           _decoder_args(gen, 2, thw, stride, c, cout, heads, 16))


# K2's and B7's (C, H, C_out) on the flagship (the first three and the last three
# are B7's only) and at small_cfg's widths
TAIL_PAIRS = [(96, 384, 192), (192, 768, 192), (192, 768, 384), (384, 1536, 384),
              (384, 1536, 768), (768, 3072, 768), (768, 1536, 384), (384, 768, 192),
              (192, 384, 96)]
SMALL_PAIRS = [(16, 64, 32), (32, 128, 64), (64, 256, 128), (128, 512, 128), (128, 256, 64),
               (64, 128, 32), (32, 64, 16)]


def _tail_case(gen, rows, c, h, cout, samples):
    """x as (samples, rows / samples, C) and the tail weights."""
    args = [_randn(gen, samples, rows // samples, c)] + _tail(gen, c, cout, h)[2:]
    dp = torch.where(torch.arange(samples, device="cuda") % 3 == 0, 0.0, 1.0)
    dp[-1] = 1.25
    return args, dp


def _check_tail(args, dp, k2: bool):
    """K2 (when ``k2``) and B7 against their twins, fp32 and bf16."""
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            cast = [a.to(dtype) if a is not None else None for a in args]
            pairs = []
            if k2:
                before = kb.fused_mlp_tail.launches
                pairs.append((kb.fused_mlp_tail(*cast), kb.fused_mlp_tail_plain(*cast)))
                assert kb.fused_mlp_tail.launches == before + 1
            before = kb.fused_mlp_tail_train.launches
            got = kb.fused_mlp_tail_train(*cast, dp)
            assert kb.fused_mlp_tail_train.launches == before + 1
            pairs += list(zip(got, kb.fused_mlp_tail_train_plain(*cast, dp)))
            torch.cuda.synchronize()
            for g_, w_ in pairs:
                assert g_.shape == w_.shape and g_.dtype == dtype
                err = float((g_.float() - w_.float()).abs().max())
                bar = (FP32_ATOL["mlp_tail"] + FP32_RTOL["mlp_tail"] * float(w_.abs().max())
                       if dtype == torch.float32 else bf16_bar("mlp_tail", w_))
                assert err <= bar, (dtype, err, bar)


@pytest.mark.parametrize("rows", [2048, 2080, 8192, 333])
@pytest.mark.parametrize("c,h,cout", TAIL_PAIRS)
def test_mlp_tail_flagship_pairs(gen, c, h, cout, rows):
    """K2 and B7 on the Hopper body at every flagship (C, H, C_out), at the
    flagship's M 2048 (v14), 2080 (the fusion blocks) and 8192 (v4-v13) and
    a ragged M, B7 with stochastic-depth factors 0, 1 and 1.25 mixed."""
    samples = {2048: 8, 2080: 8, 8192: 8, 333: 3}[rows]
    args, dp = _tail_case(gen, rows, c, h, cout, samples)
    _check_tail(args, dp, k2=(c, h, cout) in TAIL_PAIRS[3:6])


@pytest.mark.parametrize("c,h,cout", SMALL_PAIRS)
def test_mlp_tail_small_widths(gen, c, h, cout):
    """K2 and B7 at small_cfg's widths (16 to 128: reductions that end inside
    a 64-column stage, output tiles of 64)."""
    args, dp = _tail_case(gen, 2 * 130, c, h, cout, 2)
    _check_tail(args, dp, k2=True)


def test_mlp_tail_scratch_held(gen):
    """K2 and B7 park LN2's rows and GELU of the hidden in scratch buffers
    between their launches. Twice, with other allocations in between, each
    call matches the other bit for bit: a scratch buffer handed to another
    allocation while a launch still read it would not."""
    args, dp = _tail_case(gen, 8 * 260, 768, 3072, 768, 8)
    cast = [a.bfloat16() if a is not None else None for a in args]
    with torch.inference_mode():
        first = (kb.fused_mlp_tail(*cast), *kb.fused_mlp_tail_train(*cast, dp))
        churn = [torch.empty(8 * 260 * 3072 * n, dtype=torch.bfloat16, device="cuda")
                 for n in (1, 2)]
        second = (kb.fused_mlp_tail(*cast), *kb.fused_mlp_tail_train(*cast, dp))
        del churn
        torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


# --- the repaired widths and the redesigned B8 and B4 -------------------------


@pytest.mark.parametrize("b,n,lq,lk,hd", [(2, 3, 200, 130, 256), (2, 2, 150, 70, 384),
                                          (1, 2, 77, 90, 200)])
def test_attention_wide_head_dims(gen, b, n, lq, lk, hd):
    """K1 and B8 at bf16 head dims above 192 (the output columns split over
    blocks; 200 runs padded to 256) against their plain versions, and B8's
    two runs bit-equal."""
    scale = hd ** -0.5
    q, k, v = (_randn(gen, b, n, m, hd).to(torch.bfloat16) for m in (lq, lk, lk))
    g = _randn(gen, b, lq, n, hd).to(torch.bfloat16).permute(0, 2, 1, 3)
    with torch.inference_mode():
        before = ka.fused_attention.launches
        out = ka.fused_attention(q, k, v, scale)
        torch.cuda.synchronize()
        assert ka.fused_attention.launches == before + 1
        want = ka.fused_attention_plain(q, k, v, scale)
        assert float((out.float() - want.float()).abs().max()) <= bf16_bar("attention", want)
        out, lse = _lse(q, k, v, scale)
        got = ka.fused_attention_bwd(q, k, v, out, g, scale, lse)
        again = ka.fused_attention_bwd(q, k, v, out, g, scale, lse)
        want = ka.fused_attention_bwd_plain(q, k, v, out, g, scale)
        for name, x, y, z in zip(("dq", "dk", "dv"), got, want, again):
            assert x.shape == y.shape
            err = float((x.float() - y.float()).abs().max())
            bar = B8_BAR[torch.bfloat16] * max(1.0, float(y.float().abs().max()))
            assert err <= bar, (name, err, bar)
            assert torch.equal(x, z), name


@pytest.mark.parametrize("b,n,lq,lk,hd", [(8, 2, 4096, 1024, 96), (8, 4, 4096, 64, 192),
                                          (2, 2, 5000, 64, 96)])
def test_attention_bwd_bit_equal(gen, b, n, lq, lk, hd):
    """B8 without atomics: two runs of the same inputs give the same bits
    (one chunk of queries a block, and chunked with the reduction)."""
    scale = hd ** -0.5
    q, k, v = (_randn(gen, b, n, m, hd).to(torch.bfloat16) for m in (lq, lk, lk))
    g = _randn(gen, b, n, lq, hd).to(torch.bfloat16)
    with torch.inference_mode():
        out, lse = _lse(q, k, v, scale)
        first = ka.fused_attention_bwd(q, k, v, out, g, scale, lse)
        second = ka.fused_attention_bwd(q, k, v, out, g, scale, lse)
        for x, y in zip(first, second):
            assert torch.equal(x, y)


@pytest.mark.parametrize("c,h,cout", [(40, 160, 72), (40, 160, 40), (200, 792, 200),
                                      (24, 100, 24)])
def test_tails_at_widths_off_16(gen, c, h, cout):
    """K2 and B7 at widths that are not multiples of 16 (bf16 zero-padded to
    16 with LN2 over the true width; fp32 as it is) against their plain
    versions, with B7's stored hidden."""
    args = _tail_args(gen, 2, 75, c, cout, h)
    _check("mlp_tail", kb.fused_mlp_tail, kb.fused_mlp_tail_plain, args)
    dp = torch.tensor([0.0, 1.25], device="cuda")
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            cast = [None if a is None else a.to(dtype) for a in args]
            out, hid = kb.fused_mlp_tail_train(*cast, dp)
            want_out, want_hid = kb.fused_mlp_tail_train_plain(*cast, dp)
            for got, want in ((out, want_out), (hid, want_hid)):
                assert got.shape == want.shape and got.dtype == dtype
                err = float((got.float() - want.float()).abs().max())
                bar = (FP32_ATOL["mlp_tail"] + FP32_RTOL["mlp_tail"] * float(want.abs().max())
                       if dtype == torch.float32 else bf16_bar("mlp_tail", want))
                assert err <= bar, (dtype, err, bar)


def test_unfit_block_takes_k1_k2(gen):
    """A decoder block of dim 768 with three heads of 256 fits no whole-block
    instance: its route is K1+K2 (K1 at head dim 256), and its output equals
    the same block through the plain twins at B5's bf16 bar."""
    from csts_torch.models import mvit as tmvit

    spec = tmvit.AttentionSpec(dim=768, dim_out=384, num_heads=3, kernel_q=(3, 3, 3),
                               kernel_kv=(3, 3, 3), stride_q=(1, 2, 2), stride_kv=(1, 1, 1),
                               upsample_q=True)
    assert tmvit.block_route(spec, None, (4, 8, 8)) == "composite"
    blk = tmvit.MultiScaleBlock(spec)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) * 0.05)
    blk = blk.cuda().to(torch.bfloat16).eval()
    x = _randn(gen, 2, 256, 768).to(torch.bfloat16)
    with torch.inference_mode():
        n1, n2 = ka.fused_attention.launches, kb.fused_mlp_tail.launches
        got, _ = blk(x, (4, 8, 8))
        assert (ka.fused_attention.launches - n1, kb.fused_mlp_tail.launches - n2) == (1, 1)
        saved = ka.fused_attention, kb.fused_mlp_tail
        ka.fused_attention, kb.fused_mlp_tail = ka.fused_attention_plain, kb.fused_mlp_tail_plain
        try:
            want, _ = blk(x, (4, 8, 8))
        finally:
            ka.fused_attention, kb.fused_mlp_tail = saved
    assert float((got.float() - want.float()).abs().max()) <= bf16_bar("decoder_block", want)


@pytest.mark.parametrize("thw,c,cout,heads", [((4, 16, 16), 192, 192, 2),
                                              ((2, 16, 24), 192, 384, 2),
                                              ((4, 8, 8), 384, 384, 4),
                                              ((3, 10, 14), 384, 768, 4)])
def test_pool_block_split(gen, thw, c, cout, heads):
    """B4's split (the flagship's four (dim, dim_out, heads) at small grids,
    odd ones among them) against its plain version, fp32 and bf16, and
    against the plain model of the split in bf16."""
    from csts_torch.tools.ab_kernels import b4_inputs

    args = b4_inputs(thw, c, cout, heads, gen)
    _check("pool_block", kb.fused_pool_block, kb.fused_pool_block_plain,
           [a.float() if isinstance(a, torch.Tensor) else a for a in args])
    with torch.inference_mode():
        got = kb.fused_pool_block(*args)
        want = kb.fused_pool_block_split_plain(*args)
        assert float((got.float() - want.float()).abs().max()) <= bf16_bar("pool_block", want)


# --- the head dims every body takes, and the redesigned B3 and K3 -------------


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 256), (torch.float32, 320),
                                      (torch.float32, 448), (torch.bfloat16, 448),
                                      (torch.bfloat16, 512)])
def test_attention_streamed_head_dims(gen, dtype, hd):
    """K1 and B8 where the streamed bodies run (fp32 at any head dim, bf16
    above 384: the head dim in 64-column steps, the rows a block takes cut to
    fit) against their plain versions at their bars, B8 twice bit-equal."""
    b, n, lq, lk = 2, 2, 75, 130
    scale = hd ** -0.5
    assert ka.streamed(hd, dtype) and ka.kernel_head_dim(hd, dtype) == hd
    q, k, v = (_randn(gen, b, n, m, hd).to(dtype) for m in (lq, lk, lk))
    g = _randn(gen, b, lq, n, hd).to(dtype).permute(0, 2, 1, 3)
    with torch.inference_mode():
        before = ka.fused_attention.launches
        out = ka.fused_attention(q, k, v, scale)
        torch.cuda.synchronize()
        assert ka.fused_attention.launches == before + 1
        want = ka.fused_attention_plain(q, k, v, scale)
        bar = bf16_bar("attention", want) if dtype == torch.bfloat16 else FP32_ATOL["attention"]
        assert float((out.float() - want.float()).abs().max()) <= bar
        out, lse = _lse(q, k, v, scale)
        got = ka.fused_attention_bwd(q, k, v, out, g, scale, lse)
        again = ka.fused_attention_bwd(q, k, v, out, g, scale, lse)
        want = ka.fused_attention_bwd_plain(q, k, v, out, g, scale)
        for name, x, y, z in zip(("dq", "dk", "dv"), got, want, again):
            assert x.shape == y.shape and x.dtype == dtype
            err = float((x.float() - y.float()).abs().max())
            bar = B8_BAR[dtype] * max(1.0, float(y.float().abs().max()))
            assert err <= bar, (name, err, bar)
            assert torch.equal(x, z), name


@pytest.mark.parametrize("site", ["v0,a0", "v2"])
def test_block_split_flagship_sites(gen, site):
    """B3's split at the flagship's batch-8 sites (v0 and a0: 96 -> 192, one
    head, L 16384; v2: 192 -> 384, two heads, L 4096) against its plain
    version and the plain model of the split, bf16, one launch counted."""
    from csts_torch.tools.ab_kernels import B3_SITES, b3_inputs

    _, rows, c, cout, heads, _ = next(s for s in B3_SITES if s[0] == site)
    args = b3_inputs(rows, c, cout, heads, gen)
    args.append(_ln1(args))
    with torch.inference_mode():
        before = kb.fused_block.launches
        got = kb.fused_block(*args)
        torch.cuda.synchronize()
        assert kb.fused_block.launches == before + 1
        for plain in (kb.fused_block_plain, kb.fused_block_split_plain):
            want = plain(*args)
            assert float((got.float() - want.float()).abs().max()) <= bf16_bar("block", want)


@pytest.mark.parametrize("b,l,c,cout,heads", [(2, 1024, 384, 384, 4), (1, 1000, 384, 768, 4),
                                              (2, 256, 768, 768, 8), (2, 500, 96, 96, 1)])
def test_block_split_multihead(gen, b, l, c, cout, heads):
    """B3's split at ab_block's 3-8-head widths (B9b/B9c) and the 96-wide
    identity block, fp32 (the exact body) and bf16 against the plain
    version, and against the plain model of the split in bf16."""
    hd = c // heads
    k, v = _kv(gen, b, heads, 256, hd)
    args = [_randn(gen, b, l, c), k, v, hd ** -0.5, 1 + _randn(gen, c, scale=0.1),
            _randn(gen, c, scale=0.1), _randn(gen, c, c, scale=c ** -0.5),
            _randn(gen, c, scale=0.1)] + _tail(gen, c, cout, 4 * c)
    _check("block", kb.fused_block, kb.fused_block_plain, args)
    cast = [a.bfloat16() if isinstance(a, torch.Tensor) else a for a in args]
    cast.append(_ln1(cast))
    with torch.inference_mode():
        got = kb.fused_block(*cast)
        want = kb.fused_block_split_plain(*cast)
        assert float((got.float() - want.float()).abs().max()) <= bf16_bar("block", want)


def test_block_scratch_held(gen):
    """B3's split parks q, av, res1, LN2's rows and G in four scratch
    buffers between its five launches. Twice with other allocations
    in between, each call must match the plain version and the other call
    bit for bit."""
    c, cout, heads, b, l = 192, 384, 2, 2, 777
    k, v = _kv(gen, b, heads, 256, c // heads)
    args = [a.bfloat16() if isinstance(a, torch.Tensor) else a
            for a in [_randn(gen, b, l, c), k, v, (c // heads) ** -0.5,
                      1 + _randn(gen, c, scale=0.1), _randn(gen, c, scale=0.1),
                      _randn(gen, c, c, scale=c ** -0.5), _randn(gen, c, scale=0.1)]
            + _tail(gen, c, cout, 4 * c)]
    args.append(_ln1(args))
    with torch.inference_mode():
        first = kb.fused_block(*args)
        churn = [torch.empty(b * l * c * n, dtype=torch.bfloat16, device="cuda")
                 for n in (1, 2, 4, 8)]
        second = kb.fused_block(*args)
        del churn
        torch.cuda.synchronize()
        want = kb.fused_block_plain(*args)
        for got in (first, second):
            assert float((got.float() - want.float()).abs().max()) <= bf16_bar("block", want)
        assert torch.equal(first, second)


@pytest.mark.parametrize("b,thw,c", [(8, (4, 64, 64), 192),   # d4's skip
                                     (8, (4, 64, 64), 1),     # the head's stem skip
                                     (2, (3, 5, 7), 5),       # S = 175: one element a thread
                                     (3, (1, 4, 4), 8)])      # one plane: both outputs copies
def test_t2_upsample_window(gen, b, thw, c):
    """K3's sliding window at the flagship's two shapes and at an S that is
    no multiple of 16 bytes, against its plain version: fp32 within 1e-6,
    bf16 bit for bit, one launch a call."""
    x = _randn(gen, b, thw[0] * thw[1] * thw[2], c)
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            before = kup.t2_upsample.launches
            got = kup.t2_upsample(xd, thw)
            torch.cuda.synchronize()
            assert kup.t2_upsample.launches == before + 1
            want = kup.t2_upsample_plain(xd, thw)
            assert got.shape == want.shape and got.dtype == dtype
            if dtype == torch.bfloat16:
                assert torch.equal(got, want)
            else:
                assert float((got - want).abs().max()) <= 1e-6


def _eval_cfg(root, mixed: bool):
    from csts_torch.data.synthetic import write_dataset
    from csts_torch.presets import small_cfg

    prefix, splits = write_dataset(root, "ego4d", num_clips=5, res=(32, 48), seed=3)
    cfg = small_cfg(4)
    cfg.TRAIN.MIXED_PRECISION = mixed
    cfg.TRAIN.ENABLE = False
    cfg.DATA.PATH_PREFIX, cfg.DATA.PATH_TO_DATA_DIR = prefix, splits
    cfg.DATA.DECODING_BACKEND = "npy"
    cfg.DATA.GAUSSIAN_KERNEL = 5
    cfg.TEST.DATASET = "ego4d_av_gaze_forecast"
    cfg.TEST.BATCH_SIZE = 2
    cfg.TEST.NUM_ENSEMBLE_VIEWS = cfg.TEST.NUM_SPATIAL_CROPS = 1
    cfg.DATA_LOADER.NUM_WORKERS = 2
    cfg.OUTPUT_DIR = os.path.join(root, "out")
    return cfg


@pytest.mark.parametrize("mixed", [False, True])
def test_small_eval_loop_kernels_vs_plain(gen, tmp_path, monkeypatch, mixed):
    """``small_cfg``'s eval loop (spawned workers, pinned batches, the
    side-stream prefetcher) through the kernels against the same loop through
    the plain twins: the heatmaps of every batch in fp32 within 1e-5 and in
    bf16 within ``heatmap_check`` (the logits within 0.05 of the largest
    |logit|, the softmax bar 0.02, at least one decided frame and its argmax
    within 1 px), the same rows, and the whole-set metrics: fp32 with the
    same threshold and f1, recall, precision and AUC within 1e-4."""
    from csts_torch.eval import tester
    from csts_torch.tools import heatmap_check, plain_twins
    from csts_torch.train import step as step_lib

    cfg = _eval_cfg(str(tmp_path), mixed)
    make = step_lib.make_eval_step
    runs = []

    def recording(cfg_, spec_):
        step = make(cfg_, spec_)

        def run(model, batch):
            logits = []
            hook = model.register_forward_hook(lambda m, i, o: logits.append(o.float()))
            try:
                out = step(model, batch)
            finally:
                hook.remove()
            runs[-1].append((batch["index"].clone(), out.float(), logits[0]))
            return out
        return run

    monkeypatch.setattr(step_lib, "make_eval_step", recording)
    stats = []
    for ctx in (contextlib.nullcontext, plain_twins):
        runs.append([])
        with ctx():
            stats.append(tester.test(cfg))
    assert len(runs[0]) == len(runs[1]) == 3
    for (ia, a, la), (ib, b, lb) in zip(*runs):
        assert torch.equal(ia, ib)
        if mixed:
            res = heatmap_check(la, lb, probs=a)
            assert res["ok"], res
        else:
            assert float((a - b).abs().max()) <= 1e-5
    if not mixed:
        assert stats[0]["threshold"] == stats[1]["threshold"]
        for k in ("f1", "recall", "precision", "auc"):
            assert abs(stats[0][k] - stats[1][k]) <= 1e-4, (k, stats)


@pytest.mark.parametrize("size", [16, 64])
def test_auc_ties_on_the_card(gen, size):
    """bf16 heatmaps quantised to seven levels (every frame full of ties) and
    rescaled ones: the AUC on the card equals the CPU's (the stable argsort
    ranks ties in pixel order on both)."""
    from csts_torch.eval import metrics

    raw = torch.rand(4, 8, size, size, generator=gen, device="cuda")
    hm = torch.zeros_like(raw)
    hm[:, :, 3:9, 4:10] = torch.rand(4, 8, 6, 6, generator=gen, device="cuda") + 0.01
    for p in ((raw * 6).round() / 6, metrics.minmax_rescale(raw.to(torch.bfloat16))):
        p = p.to(torch.bfloat16)
        auc, valid = metrics.auc_per_frame(p, hm)
        cpu_auc, cpu_valid = metrics.auc_per_frame(p.cpu(), hm.cpu())
        assert torch.equal(valid.cpu(), cpu_valid)
        assert float((auc.cpu() - cpu_auc).abs().max()) <= 1e-6


def test_small_trainer_kernels_vs_plain(gen, tmp_path, monkeypatch):
    """``small_cfg``'s trainer on the card (fp32, TF32 off, drop-path 0.2,
    EMA, 2 epochs of 2 iterations, 2 loader workers, validation each
    epoch) through the kernels against the same run through the plain twins
    (training and eval routes): the first step's loss within 1e-5 relative
    and every later one within 1e-4 (test_torch_train.py's step bars), each
    iteration's lr equal, and the final weights within 2·Σlr of each other;
    then the npz round trip: the last checkpoint loaded into a fresh state
    gives back the run's weights, moments, counts and EMA bit for bit."""
    import numpy as np

    from chip_smoke import WRAPPERS, reset_launches
    from csts_torch.models.csts import build_spec
    from csts_torch.tools import plain_twins
    from csts_torch.train import meters, trainer
    from csts_torch.train import step as step_lib
    from csts_torch.utils import checkpoint as cu

    torch.backends.cudnn.allow_tf32 = False
    cfg = _eval_cfg(str(tmp_path), mixed=False)
    cfg.TRAIN.ENABLE = True
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.MVIT.DROPPATH_RATE = 0.2
    cfg.SOLVER.EMA_DECAY = 0.9
    cfg.SOLVER.MAX_EPOCH = 2
    cfg.TRAIN.EVAL_PERIOD = cfg.TRAIN.CHECKPOINT_PERIOD = 1
    seen = []
    update = meters.TrainGazeMeter.update_stats

    def record(self, f1, r, p, th, loss, lr, mb_size):
        seen[-1].append((loss, lr))
        return update(self, f1, r, p, th, loss, lr, mb_size)

    monkeypatch.setattr(meters.TrainGazeMeter, "update_stats", record)
    states = []
    for tag in ("kernels", "plain"):
        seen.append([])
        cfg.OUTPUT_DIR = str(tmp_path / tag)
        ctx = (contextlib.nullcontext() if tag == "kernels"
               else contextlib.ExitStack())
        with ctx as stack:
            if tag == "plain":
                stack.enter_context(plain_twins())
            reset_launches()
            states.append(trainer.train(cfg))
            if tag == "kernels":
                ran = {n: WRAPPERS[n].launches for n in ("attention", "attention_bwd",
                                                         "mlp_tail_train", "t2_upsample")}
                assert all(ran.values()), ran
    (lk, rk), (lp, rp) = seen[0][0], seen[1][0]
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for (lk, rk), (lp, rp) in zip(seen[0], seen[1]):
        assert abs(lk - lp) <= 1e-4 * abs(lp) and rk == rp
    lrs = sum(lr for _, lr in seen[1])
    plain = dict(states[1].model.named_parameters())
    for n, p in states[0].model.named_parameters():
        assert float((p.detach() - plain[n].detach()).abs().max()) <= 2 * lrs, n
    path = cu.get_last_checkpoint(str(tmp_path / "kernels"))
    fresh = step_lib.create_train_state(cfg, build_spec(cfg), torch.Generator().manual_seed(5),
                                        device="cuda")
    cu.load_checkpoint(path, fresh)
    for a, b in zip(cu.state_leaves(fresh), cu.state_leaves(states[0])):
        assert np.array_equal(a, b)


def test_orbax_round_trip_on_the_card(gen, tmp_path):
    """TRAIN.CHECKPOINT_BACKEND "orbax"'s checkpointer on CUDA tensors:
    ``small_cfg`` (BF16_MOMENTS, EMA) after a step through the kernels,
    saved (staged to pinned host memory, written on DCP's thread), then
    restored into a fresh state on the card and into one on the CPU: both
    equal to the saved state's ``state_leaves``, the first moment bf16."""
    import numpy as np

    from csts_torch import presets
    from csts_torch.models.csts import build_spec
    from csts_torch.train import step as step_lib
    from csts_torch.utils import checkpoint as cu
    from csts_torch.utils import orbax_ckpt
    from test_torch_multiproc import _random_batch

    cfg = presets.small_cfg(2)
    cfg.SOLVER.BF16_MOMENTS = True
    cfg.SOLVER.EMA_DECAY = 0.9
    spec = build_spec(cfg)
    state = step_lib.create_train_state(cfg, spec, torch.Generator().manual_seed(0),
                                        device="cuda")
    batch = {k: v.cuda() for k, v in _random_batch(2, cfg).items()}
    step_lib.make_train_step(cfg, spec, 10)(state, batch, torch.Generator().manual_seed(1))
    ck = orbax_ckpt.OrbaxCheckpointer(str(tmp_path))
    ck.save(state, 1)
    ck.close()
    want = cu.state_leaves(state)
    for device in ("cuda", "cpu"):
        fresh = step_lib.create_train_state(cfg, spec, torch.Generator().manual_seed(7),
                                            device=device)
        assert orbax_ckpt.OrbaxCheckpointer(str(tmp_path)).restore(fresh)[1] == 1
        first = fresh.optimizer.local.state[next(fresh.model.parameters())]["exp_avg"]
        assert first.dtype == torch.bfloat16 and first.device.type == device
        for i, (a, b) in enumerate(zip(cu.state_leaves(fresh), want)):
            assert a.dtype == b.dtype and np.array_equal(a, b), (device, i)


# ----------------------------------------------------------------------------------
# serving: the graph per bucket, a stale graph, the artifact exported on the card
# ----------------------------------------------------------------------------------


def _small_predictor(buckets):
    """small_cfg's predictor in bf16 on the card, from seeded weights."""
    from csts_torch.serving import GazePredictor

    cfg, _, ref, _, _ = _small_model(1)
    cfg.TRAIN.MIXED_PRECISION = True
    return GazePredictor(cfg, ref.state_dict(), batch_sizes=buckets)


def _small_requests(pred, n, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    cfg = pred.cfg
    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    return (rng.standard_normal((n, t, s, s, 3), dtype=np.float32),
            rng.standard_normal((n, t, cfg.DATA.AUDIO_FREQ_BINS, cfg.DATA.AUDIO_WINDOW, 1),
                                dtype=np.float32))


def test_graph_replay_bit_equal_to_eager(gen):
    """At buckets 1 and 4: the first request runs eagerly (the wrappers
    count), the second captures (they count again), the third replays (no
    Python launch); the replay's heatmaps equal the eager forward's bit for
    bit, padding included."""
    import numpy as np

    from chip_smoke import WRAPPERS, reset_launches

    pred = _small_predictor((1, 4))
    for bucket, n in ((1, 1), (4, 3)):
        video, audio = _small_requests(pred, n, bucket)
        counts = []
        for _ in range(3):
            reset_launches()
            out = pred.predict(video, audio)
            torch.cuda.synchronize()
            counts.append(WRAPPERS["attention"].launches)
        assert counts[0] > 0 and counts[1] == counts[0] and counts[2] == 0, counts
        assert pred._slots[bucket].graph is not None
        pad = bucket - n
        v = torch.from_numpy(np.concatenate([video, np.repeat(video[-1:], pad, 0)])).cuda()
        a = torch.from_numpy(np.concatenate([audio, np.repeat(audio[-1:], pad, 0)])).cuda()
        eager = pred.forward(v, a)[:n, ..., 0].float().cpu().numpy()
        np.testing.assert_array_equal(out["heatmaps"], eager)


def test_host_requests_staged_in_pinned_buffers(gen):
    """A request from host memory goes through the bucket's pinned staging
    buffers; its heatmaps equal those of the same clips sent from device
    memory, bit for bit, and a second host request reuses the buffers."""
    import numpy as np

    pred = _small_predictor((4,))
    video, audio = _small_requests(pred, 3, 5)
    for _ in range(3):
        host = pred.predict(video, audio)
    slot = pred._slots[4]
    assert all(st.is_pinned() for st in slot.stage)
    stage = [st.data_ptr() for st in slot.stage]
    device = pred.serve(torch.from_numpy(video).cuda(), torch.from_numpy(audio).cuda())
    np.testing.assert_array_equal(device[..., 0].float().cpu().numpy(), host["heatmaps"])
    again = pred.predict(video, audio)
    assert [st.data_ptr() for st in slot.stage] == stage
    np.testing.assert_array_equal(again["heatmaps"], host["heatmaps"])


def test_stale_graph_recaptures_after_a_switch(gen):
    """hw2_skip flipped after a capture: the next request runs B9a (a stale
    replay would run none), the one after captures with it, and flipping
    back starts the bucket over again."""
    from chip_smoke import WRAPPERS, reset_launches
    from csts_torch.tools import ab_flags

    pred = _small_predictor((2,))
    video, audio = _small_requests(pred, 2, 0)
    for _ in range(3):
        base = pred.predict(video, audio)
    with ab_flags.flags("head_commute+t2_skip+hw2_skip"):  # hw2_skip beside the defaults
        hw2 = []
        for _ in range(3):
            reset_launches()
            on = pred.predict(video, audio)
            hw2.append(WRAPPERS["hw2_upsample"].launches)
    assert hw2[0] > 0 and hw2[1] == hw2[0] and hw2[2] == 0, hw2
    reset_launches()
    off = pred.predict(video, audio)
    assert WRAPPERS["hw2_upsample"].launches == 0 and WRAPPERS["attention"].launches > 0
    assert (off["heatmaps"] == base["heatmaps"]).all()
    assert abs(on["heatmaps"] - base["heatmaps"]).max() < 0.02


def test_cuda_export_roundtrip(gen, tmp_path):
    """export_compiled on the card, from_exported: its predict launches the
    kernels (the counters move), eagerly and at the capture, and answers as
    the live predictor does (bit-equal, or else within the golden bar)."""
    import json

    import numpy as np

    from chip_smoke import PER_FORWARD, WRAPPERS, reset_launches
    from csts_torch.serving import GazePredictor
    from csts_torch.tools import softmax_check

    pred = _small_predictor((2,))
    video, audio = _small_requests(pred, 2, 1)
    live = pred.predict(video, audio)
    pred.export_compiled(str(tmp_path))
    assert json.load(open(tmp_path / "meta.json"))["platforms"] == ["cuda"]
    exp = GazePredictor.from_exported(str(tmp_path))
    for run in range(3):  # eager, capture, replay
        reset_launches()
        out = exp.predict(video, audio)
        ran = {n: WRAPPERS[n].launches for n in PER_FORWARD}
        if run < 2:
            assert all(ran[n] > 0 for n in ("attention", "mlp_tail", "t2_upsample", "block",
                                            "pool_block", "decoder_block")), ran
        if not np.array_equal(out["heatmaps"], live["heatmaps"]):
            res = softmax_check(torch.from_numpy(out["heatmaps"]),
                                torch.from_numpy(live["heatmaps"]))
            assert res["softmax_max_abs_diff"] < 0.02 and res["argmax_off_on_decided"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_max_pool_backward_fixed_order_on_the_card(gen, dtype):
    """The encoder skip's max pool at a flagship-like grid with ties: the
    training route's backward (``ops.max_pool3d`` on a tensor that wants a
    gradient) gives the same bits twice, and agrees with F.max_pool3d's
    backward in fp64 on the CPU (fp32 1e-6; bf16 within one rounding of
    the bf16 cotangent's sums)."""
    from csts_torch import ops

    x = (_randn(gen, 2, 4, 32, 32, 48) * 2).round().to(dtype)  # ties in most windows
    g = _randn(gen, 2, 4, 16, 16, 48).to(dtype)
    grads = []
    for _ in range(2):
        xt = x.clone().requires_grad_()
        ops.max_pool3d(xt, (1, 3, 3), (1, 2, 2), (0, 1, 1)).backward(g)
        grads.append(xt.grad)
    assert torch.equal(grads[0], grads[1])
    ref = x.double().cpu().permute(0, 4, 1, 2, 3).requires_grad_()
    torch.nn.functional.max_pool3d(ref, (1, 3, 3), (1, 2, 2), (0, 1, 1)).backward(
        g.double().cpu().permute(0, 4, 1, 2, 3))
    want = ref.grad.permute(0, 2, 3, 4, 1)
    err = (grads[0].double().cpu() - want).abs()
    bar = 1e-6 if dtype == torch.float32 else 2 ** -8
    assert float((err / (1 + want.abs())).max()) <= bar


# ----------------------------------------------------------------------------------
# several processes: two gloo ranks sharing the card
# ----------------------------------------------------------------------------------


def test_small_ddp_two_ranks_on_the_card(gen, tmp_path):
    """``small_cfg`` at global batch 4 on two gloo ranks sharing device 0
    (batch 2 each, DDP, fp32, TF32 off, kldiv+egonce over the gathered
    embeddings, drop-path 0.2 with the global batch's masks), through the
    kernels in each rank, against one process at batch 4 on the card from
    the same weights, batch and masks: each step's loss within 1e-5
    relative, each gradient after step 1 within 1e-3 of its norm plus 1e-6
    of the whole gradient's (chip_smoke's whole-step bars: the kernels sum
    in other orders), the params after step 2 within 2·Σlr, and every
    training kernel launched in each rank."""
    import numpy as np

    from chip_smoke import STEP_GRAD_FLOOR, STEP_GRAD_RTOL, STEP_LOSS_RTOL
    from csts_torch.models.csts import build_spec, init_params, CSTS
    from csts_torch.ops import sample_drop_masks
    from csts_torch.train import step as step_lib
    from test_torch_multiproc import run_ranks, run_steps, step_cfg, step_worker

    torch.backends.cudnn.allow_tf32 = False
    cfg = step_cfg()
    spec = build_spec(cfg)
    model = CSTS(spec)
    init_params(model, torch.Generator().manual_seed(3))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(2)
    hm = rng.uniform(0.0, 1.0, (4, 8, 8, 8)).astype(np.float32)
    batch = {"video": torch.from_numpy(rng.standard_normal((4, 8, 32, 32, 3), np.float32)),
             "audio": torch.from_numpy(rng.standard_normal((4, 8, 32, 32, 1), np.float32)),
             "labels_hm": torch.from_numpy(hm / hm.sum(axis=(2, 3), keepdims=True))}
    drops = [sample_drop_masks(spec.video_blocks, 4, torch.Generator().manual_seed(s))
             for s in (7, 8)]
    torch.save({"sd": sd, "batch": batch, "drops": drops}, tmp_path / "inputs.pt")
    one = step_lib.create_train_state(cfg, spec, state_dict=sd, device="cuda")
    want = run_steps(one, cfg, {k: v.cuda() for k, v in batch.items()},
                     [[None if m is None else tuple(x.cuda() for x in m) for m in d]
                      for d in drops])
    run_ranks(step_worker, str(tmp_path / "inputs.pt"), str(tmp_path), ("ddp",), "cuda",
              timeout=300)
    got = torch.load(tmp_path / "ddp.pt")
    assert all(got["launches"].values()), got["launches"]
    for g, w in zip(got["stats"], want["stats"]):
        assert abs(g["loss"] - w["loss"]) <= STEP_LOSS_RTOL * abs(w["loss"]), (g, w)
    norm = lambda t: float(torch.linalg.vector_norm(t))  # noqa: E731
    total = float(np.sqrt(sum(norm(g) ** 2 for g in want["grads"].values())))
    for n, w in want["grads"].items():
        assert norm(got["grads"][n] - w) <= STEP_GRAD_RTOL * norm(w) + STEP_GRAD_FLOOR * total, n
    bar = 2 * sum(s["lr"] for s in want["stats"])
    for n, w in want["params"].items():
        assert float((got["params"][n] - w).abs().max()) <= bar, n


GROUP_OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
             "reduce_scatter_tensor")


def _group_op(name: str, rank: int) -> None:
    import torch.distributed as dist

    x = torch.full((4,), float(rank + 1), device="cuda")
    if name == "all_reduce":
        dist.all_reduce(x)
    elif name == "broadcast":
        dist.broadcast(x, src=0)
    elif name == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(2)], x)
    elif name == "all_gather_into_tensor":
        dist.all_gather_into_tensor(torch.empty(8, device="cuda"), x)
    else:
        dist.reduce_scatter_tensor(torch.empty(2, device="cuda"), x)
    torch.cuda.synchronize()


def group_worker(rank: int, backend: str, init: str, out: str) -> None:
    """One of two ranks on device 0: what ``backend`` does at
    ``init_process_group`` and with each of GROUP_OPS on CUDA tensors, in its
    own words, to ``out/{backend}{rank}.json``."""
    import datetime
    import json

    import torch.distributed as dist

    torch.cuda.set_device(0)
    res = {}
    try:
        dist.init_process_group(
            backend, init_method=init, world_size=2, rank=rank,
            timeout=datetime.timedelta(seconds=30),
            device_id=torch.device("cuda", 0) if backend == "nccl" else None)
    except Exception as exc:  # noqa: BLE001 — the test reads what the backend says
        res["init"] = f"{type(exc).__name__}: {exc}"
    else:
        res["init"] = "ok"
        for name in GROUP_OPS:
            try:
                _group_op(name, rank)
                res[name] = "ok"
            except Exception as exc:  # noqa: BLE001
                res[name] = f"{type(exc).__name__}: {exc}"
                break  # a failed communicator takes no further work
        dist.destroy_process_group()
    with open(os.path.join(out, f"{backend}{rank}.json"), "w") as f:
        json.dump(res, f)


def test_two_ranks_on_one_card_need_gloo(gen, tmp_path):
    """Why two ranks sharing the card (``chip_smoke.py`` phase 8, the DDP
    test above) run over gloo: NCCL refuses two ranks on one device (at
    ``init_process_group`` or the first collective; a group that hangs is
    killed after 90 s and counts as refused), while gloo runs on CUDA
    tensors the c10d collectives DDP and ZeRO-1 use and those FSDP2's
    parameters and gradients go through. Each rank's words are printed."""
    import json
    import time

    got = {}
    for backend in ("nccl", "gloo"):
        out = tmp_path / backend
        out.mkdir()
        ctx = torch.multiprocessing.start_processes(
            group_worker, args=(backend, f"file://{out / 'store'}", str(out)), nprocs=2,
            join=False, start_method="spawn")
        deadline = time.monotonic() + 90
        try:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    break
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        got[backend] = {r: json.loads((out / f"{backend}{r}.json").read_text())
                        for r in range(2) if (out / f"{backend}{r}.json").exists()}
    print(json.dumps({"torch": torch.__version__, "nccl": torch.cuda.nccl.version(), **got}))
    assert len(got["gloo"]) == 2, got
    assert all(r.get(k) == "ok" for r in got["gloo"].values() for k in ("init", *GROUP_OPS)), got
    refused = len(got["nccl"]) < 2 or any(v != "ok" for r in got["nccl"].values()
                                          for v in r.values())
    assert refused, got


# ----------------------------------------------------------------------------------
# the MViT classifier: K1, K2 and B3 at its shapes (ragged key counts, the cls
# row, odd row counts) and the small classifier through the kernels
# ----------------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,lq,lk", [
    (1, 4, 1569, 1569),   # v3 with the cls token at batch 1: two key splits, a ragged chunk
    (1, 8, 393, 1569),    # v14: four key splits
    (2, 2, 6273, 393),    # v2: seven chunks, the last of 9 keys
    (1, 1, 25089, 393),   # v0
])
def test_attention_classifier_shapes(gen, b, n, lq, lk):
    hd = 96
    q, k, v = _randn(gen, b, n, lq, hd), _randn(gen, b, n, lk, hd), _randn(gen, b, n, lk, hd)
    _check("attention", ka.fused_attention, ka.fused_attention_plain, [q, k, v, hd ** -0.5])
    splits = ka.key_splits(b * n, lq, lk, torch.cuda.get_device_properties(0).multi_processor_count)
    if splits > 1:
        with torch.inference_mode():
            q16, k16, v16 = q.bfloat16(), k.bfloat16(), v.bfloat16()
            got = ka.fused_attention(q16, k16, v16, hd ** -0.5)
            want = ka.fused_attention_split_plain(q16, k16, v16, hd ** -0.5, splits)
        assert float((got.float() - want.float()).abs().max()) <= split_bar(want)


@pytest.mark.parametrize("m,c,cout", [(25089, 96, 192), (6273, 192, 384), (393, 768, 768)])
def test_mlp_tail_classifier_rows(gen, m, c, cout):
    """K2 at the classifier's odd row counts (its blocks' L + 1 with the cls token)."""
    h = 4 * c
    args = [_randn(gen, 1, m, c), 1 + _randn(gen, c, scale=0.1), _randn(gen, c, scale=0.1),
            _randn(gen, h, c, scale=c ** -0.5), _randn(gen, h, scale=0.1),
            _randn(gen, cout, h, scale=h ** -0.5), _randn(gen, cout, scale=0.1)]
    if c != cout:
        args += [_randn(gen, cout, c, scale=c ** -0.5), _randn(gen, cout, scale=0.1)]
    _check("mlp_tail", kb.fused_mlp_tail, kb.fused_mlp_tail_plain, args)


@pytest.mark.parametrize("b,l,c,cout,heads,lk", [
    (1, 25088, 96, 192, 1, 392),    # the classifier's v0 without the cls token
    (1, 6272, 192, 384, 2, 392),    # its v2
])
def test_block_classifier_shapes(gen, b, l, c, cout, heads, lk):
    hd = c // heads
    k, v = _kv(gen, b, heads, lk, hd)
    args = [_randn(gen, b, l, c), k, v, hd ** -0.5, 1 + _randn(gen, c, scale=0.1),
            _randn(gen, c, scale=0.1), _randn(gen, c, c, scale=c ** -0.5),
            _randn(gen, c, scale=0.1)] + _tail(gen, c, cout, 4 * c)
    _check("block", kb.fused_block, kb.fused_block_plain, args)


def _small_classifier_cfg(cls: bool, crop: int):
    """tests/test_mvit_classifier.py's small classifier (8 frames, depth 4,
    width 16) at crop ``crop``, cls token on or off."""
    from csts_torch.config import get_cfg

    cfg = get_cfg()
    cfg.DATA.TRAIN_CROP_SIZE = cfg.DATA.TEST_CROP_SIZE = crop
    cfg.DATA.NUM_FRAMES = 8
    cfg.MVIT.PATCH_PADDING = [1, 3, 3]
    cfg.MVIT.CLS_EMBED_ON = cls
    cfg.MVIT.SEP_POS_EMBED = True
    cfg.MVIT.DEPTH = 4
    cfg.MVIT.EMBED_DIM = 16
    cfg.MVIT.DIM_MUL = [[1, 2.0], [2, 2.0], [3, 2.0]]
    cfg.MVIT.HEAD_MUL = [[1, 2.0], [2, 2.0], [3, 2.0]]
    cfg.MVIT.POOL_KVQ_KERNEL = [3, 3, 3]
    cfg.MVIT.POOL_KV_STRIDE_ADAPTIVE = [1, 4, 4]
    cfg.MVIT.POOL_Q_STRIDE = [[1, 1, 2, 2], [2, 1, 2, 2], [3, 1, 2, 2]]
    cfg.MODEL.MODEL_NAME = "MVIT"
    cfg.MODEL.NUM_CLASSES = 11
    cfg.TRAIN.MIXED_PRECISION = True
    return cfg


@pytest.mark.parametrize("crop", [48, 80])
@pytest.mark.parametrize("cls", [True, False], ids=["cls", "no_cls"])
def test_small_classifier_through_kernels(gen, cls, crop):
    """The small classifier's bf16 forward from ``build_model`` through the
    kernels (ragged key counts: 37 and 101 keys at v0 with the cls token, 36
    and 100 without) against the fp32 plain twins: the launches as
    ``block_route`` plans them (with the cls token K1+K2 at every block;
    without it B3 at v0, the one identity-skip block, and B4 at the three
    Q-pool blocks, whose keys stay few at this size), each recorded launch
    against its plain twin at the card's bars (``chip_smoke.check_kernels``),
    the logits within 0.05 of the largest and the top class equal where
    decided."""
    import copy

    import numpy as np

    from chip_smoke import WRAPPERS, check_kernels, classifier_plan, recording, reset_launches
    from csts_torch.models.build import build_model
    from csts_torch.models.mvit_classifier import MViT, build_mvit_spec
    from csts_torch.tools import plain_twins

    cfg = _small_classifier_cfg(cls, crop)
    model = build_model(cfg, device="cuda").to(torch.bfloat16).eval()
    cfg32 = copy.deepcopy(cfg)
    cfg32.TRAIN.MIXED_PRECISION = False
    ref = MViT(build_mvit_spec(cfg32))
    ref.load_state_dict(model.state_dict())
    ref = ref.cuda().eval()
    plan = classifier_plan(model)
    assert plan["block"] == plan["pool_block"] // 3 == (0 if cls else 1)
    assert plan["attention"] + plan["block"] + plan["pool_block"] == 4
    video = torch.from_numpy(
        np.random.default_rng(crop).standard_normal((3, 8, crop, crop, 3), dtype=np.float32)).cuda()
    calls = {name: {} for name in ("attention", "mlp_tail", "block", "pool_block")}
    with torch.inference_mode():
        with recording(calls):
            model(video)
        reset_launches()
        logits = model(video).float()
        torch.cuda.synchronize()
        launches = {name: WRAPPERS[name].launches for name in plan}
        with plain_twins():
            want = ref(video)
    assert launches == plan, (launches, plan)
    assert {n: sum(c for c, _, _ in sigs.values()) for n, sigs in calls.items()} == {
        n: plan[n] for n in calls}
    check_kernels({3: calls}, timing=None)
    err = float((logits - want).abs().max())
    assert err <= 0.05 * max(1.0, float(want.abs().max())), err
    top2 = want.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * err
    assert bool((logits.argmax(-1) == want.argmax(-1))[decided].all())


@pytest.mark.parametrize("axis", ["pipe", "model", "seq"])
def test_model_axes_two_ranks_share_the_card(gen, tmp_path, axis):
    """``small_cfg`` at 6 video blocks on two gloo ranks sharing the card
    under a mesh of ``axis`` = 2 (``tests/torch_axes_workers.py``), against
    one process on the card from the same weights, batch and masks: the
    fp32 eval logits within 1e-4 of max(1, the largest |logit|) (the kernels
    sum in other orders at other batch sizes), one training step at
    chip_smoke's whole-step bars (loss 1e-5 relative, each gradient 1e-3 of
    its norm plus 1e-6 of the whole gradient's, the params within 2·lr),
    and each rank's forward and step launching the kernels."""
    _axes_share_the_card(tmp_path, {axis: 2}, 2)


def test_seq_with_pipe_four_ranks_share_the_card(gen, tmp_path):
    """The same at sp2 x pp2 on four gloo ranks sharing the card: the
    pipelined run's stages on the seq axis's stripes (K1 and B7 on each
    stripe's rows inside the stages' nested backward)."""
    _axes_share_the_card(tmp_path, {"seq": 2, "pipe": 2}, 4)


def _axes_share_the_card(tmp_path, axes: dict, world: int) -> None:
    import numpy as np

    from chip_smoke import STEP_GRAD_FLOOR, STEP_GRAD_RTOL, STEP_LOSS_RTOL
    from csts_torch.models.csts import CSTS, build_spec, init_params
    from csts_torch.ops import sample_drop_masks
    from csts_torch.train import step as step_lib
    from test_torch_multiproc import run_ranks
    from torch_axes_workers import axes_cfg, axes_worker, whole_grads, whole_params

    torch.backends.cudnn.allow_tf32 = False
    cfg = axes_cfg(4)
    spec = build_spec(cfg)
    model = CSTS(spec)
    init_params(model, torch.Generator().manual_seed(5))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(6)
    hm = rng.uniform(0.0, 1.0, (4, 8, 8, 8)).astype(np.float32)
    batch = {"video": torch.from_numpy(rng.standard_normal((4, 8, 32, 32, 3), np.float32)),
             "audio": torch.from_numpy(rng.standard_normal((4, 8, 32, 32, 1), np.float32)),
             "labels_hm": torch.from_numpy(hm / hm.sum(axis=(2, 3), keepdims=True))}
    drop = sample_drop_masks(spec.video_blocks, 4, torch.Generator().manual_seed(9))
    torch.save({"sd": sd, "batch": batch, "drop": drop}, tmp_path / "inputs.pt")
    cbatch = {k: v.cuda() for k, v in batch.items()}
    cdrop = [None if m is None else tuple(x.cuda() for x in m) for m in drop]
    model = model.cuda().eval()
    with torch.inference_mode():
        want_logits = model(cbatch["video"], cbatch["audio"]).cpu()
    one = step_lib.create_train_state(cfg, spec, state_dict=sd, device="cuda")
    stats, _ = step_lib.make_train_step(cfg, spec, 10)(one, cbatch, None, drop=cdrop)
    want = {"loss": float(stats["loss"]), "grads": whole_grads(one.model),
            "params": whole_params(one.model), "lr": float(stats["lr"])}
    run_ranks(axes_worker, str(tmp_path / "inputs.pt"), str(tmp_path), axes, "cuda",
              world=world, timeout=300)
    norm = lambda t: float(torch.linalg.vector_norm(t))  # noqa: E731
    total = float(np.sqrt(sum(norm(g) ** 2 for g in want["grads"].values())))
    for r in range(world):
        got = torch.load(tmp_path / f"rank{r}.pt")
        err = float((got["logits"] - want_logits).abs().max())
        assert err <= 1e-4 * max(1.0, float(want_logits.abs().max())), (r, err)
        assert abs(got["stats"]["loss"] - want["loss"]) <= STEP_LOSS_RTOL * abs(want["loss"])
        for n, w in want["grads"].items():
            assert norm(got["grads"][n] - w) <= STEP_GRAD_RTOL * norm(w) + STEP_GRAD_FLOOR * total, n
        for n, w in want["params"].items():
            assert float((got["params"][n] - w).abs().max()) <= 2 * want["lr"], n
        for key in ("launches_forward", "launches_step"):
            assert got[key]["attention"] > 0, (key, got[key])
        assert got["launches_step"]["attention_bwd"] > 0 and got["launches_step"]["mlp_tail_train"] > 0
        assert all(got["counts"].get(axis, 0) > 0 for axis in axes), got["counts"]

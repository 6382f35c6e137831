"""The CUDA kernels against their plain versions on the card, at ragged shapes
the flagship forward does not reach (``chip_smoke.py`` covers the flagship's
own): partial query and key tiles, head views with strides, head dims 64 and
128, output widths and hidden widths that leave partial weight tiles.

They skip without a card. On one, run them without the JAX suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from chip_smoke import FP32_ATOL, FP32_RTOL, bf16_bar
from csts_torch.kernels import attention as ka
from csts_torch.kernels import block as kb
from csts_torch.kernels import upsample as kup
from csts_torch.models.mvit import build_inframe_mask

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def _check(name, kernel, plain, args, keep=()):
    """Kernel vs plain version in fp32 and in bf16, at the bars of chip_smoke.
    Arguments at the indices in ``keep`` stay as they are (the fp32 mask)."""
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            cast = [a.to(dtype) if isinstance(a, torch.Tensor) and i not in keep else a
                    for i, a in enumerate(args)]
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


def test_kernels_refuse_gradients(gen):
    """Forward-only kernels: an input that wants a gradient is refused."""
    q = _randn(gen, 1, 1, 16, 64).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        ka.fused_attention(q, q, q, 0.125)
    x = _randn(gen, 1, 8, 16).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        kup.t2_upsample(x, (2, 2, 2))

"""The port's counterparts of the JAX package's last three Pallas kernels and
the entry points that reach them, on the CPU against the JAX package:

* B9a ``kup.hw2_upsample`` (its plain twin here) against ``hw2_upsample``
  run in interpret mode, and the switch ``HW2_SKIP_KERNEL`` in
  ``upsample_tokens_trilinear`` and in a decoder block on B5's route;
* B9b/B9c: the port's whole block at 4 and 8 heads (phase 1 +
  ``kb.fused_block``, the plain twin here) against ``fused_block(variant=
  "hg")`` and ``variant="bd"`` in interpret mode;
* B5's ``whole_vol`` mode (``DEC_VOL_VIEWS``) against the port's B5;
* CPU runs of ``csts_torch.tools.ab_block``, ``ab_flags`` and
  ``profile_forward`` at narrow shapes.

Inputs come from numpy seeds; weights from JAX init through the port's
converter. ``tests/test_torch_cuda.py`` holds the CUDA kernels against these
twins on the card.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from csts_tpu.kernels import block as jkb
from csts_tpu.kernels import upsample as jup
from csts_tpu.models import mvit as jmvit
from csts_torch import presets
from csts_torch.convert.from_jax import _block
from csts_torch.kernels import block as kb
from csts_torch.kernels import upsample as kup
from csts_torch.models import csts as tcsts
from csts_torch.models import mvit as tmvit
from csts_torch.tools import ab_block, ab_flags, profile_forward

torch.set_num_threads(2)

HW2_SHAPES = [(2, 8, 8, 128), (3, 16, 8, 256), (2, 5, 7, 96)]  # (T, H, W, C)


def _x(shape, seed=3):
    t, h, w, c = shape
    return np.random.default_rng(seed).standard_normal((2, t * h * w, c)).astype(np.float32)


@pytest.mark.parametrize("shape", HW2_SHAPES)
def test_hw2_plain_matches_pallas_fp32(shape):
    x = _x(shape)
    thw = shape[:3]
    want = np.asarray(jup.hw2_upsample(jnp.asarray(x), thw, interpret=True))
    got = kup.hw2_upsample(torch.from_numpy(x), thw).numpy()
    assert got.shape == want.shape == (2, 4 * x.shape[1], shape[3])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", HW2_SHAPES)
def test_hw2_plain_matches_pallas_bf16(shape):
    """Both round the H pass to bf16 before the W pass and the output once
    more: equal to within one bf16 ulp of each value (0 expected)."""
    x = _x(shape, seed=4)
    thw = shape[:3]
    want = np.asarray(jup.hw2_upsample(jnp.asarray(x, jnp.bfloat16), thw, interpret=True),
                      np.float32)
    got = kup.hw2_upsample(torch.from_numpy(x).bfloat16(), thw).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert np.all(np.abs(got - want) <= ulp)
    assert np.abs(got - want).max() == 0.0


def _composite(x, thw, stride):
    up, _ = jmvit.upsample_tokens_trilinear(jnp.asarray(x), thw, stride)
    return np.asarray(up)


def test_hw2_switch_in_upsample_tokens_trilinear(monkeypatch):
    """On B5's route the switch sends a (1,2,2) skip to B9a; off, or in
    training, or on any other route, the skip is the composite resize."""
    shape = (2, 5, 6, 24)
    x = _x(shape, seed=5)
    thw = shape[:3]
    xt = torch.from_numpy(x)
    hw2 = np.asarray(jup.hw2_upsample(jnp.asarray(x), thw, interpret=True))
    composite = _composite(x, thw, (1, 2, 2))
    calls = []
    orig = kup.hw2_upsample
    monkeypatch.setattr(kup, "hw2_upsample", lambda *a: calls.append(1) or orig(*a))
    assert kup.HW2_SKIP_KERNEL is False  # the JAX package's default

    def port(**kw):
        out, size = tmvit.upsample_tokens_trilinear(xt, thw, (1, 2, 2), **kw)
        assert size == (2, 10, 12)
        return out.numpy()

    np.testing.assert_allclose(port(decoder_kernel=True), composite, atol=1e-6)
    assert not calls
    monkeypatch.setattr(kup, "HW2_SKIP_KERNEL", True)
    np.testing.assert_allclose(port(decoder_kernel=True), hw2, atol=1e-6)
    assert len(calls) == 1
    np.testing.assert_allclose(port(decoder_kernel=True, train=True), composite, atol=1e-6)
    np.testing.assert_allclose(port(), composite, atol=1e-6)  # the K1+K2 route (d1)
    assert len(calls) == 1
    # the (2,1,1) skip stays on K3 whatever the switch
    t2 = tmvit.upsample_tokens_trilinear(xt, thw, (2, 1, 1), decoder_kernel=True)[0]
    np.testing.assert_allclose(t2.numpy(), _composite(x, thw, (2, 1, 1)), atol=1e-6)
    assert len(calls) == 1


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


def test_decoder_block_takes_hw2_on_b5_route(monkeypatch):
    """A d3-like decoder block at eval with the switch on: its skip goes
    through B9a once and the block equals the JAX package's decoder-kernel
    forward with ``HW2_SKIP_KERNEL`` on (Pallas in interpret mode)."""
    import functools

    thw = (2, 8, 8)
    jspec, params, block = _pair(384, 192, 4, (1, 2, 2), (1, 2, 2), upsample=True, seed=11)
    x = (np.random.default_rng(11).standard_normal((1, 128, 384)) * 0.5).astype(np.float32)
    thw_f = jmvit._static_upsample_out(thw, jspec.kernel_q, jspec.stride_q, jspec.padding_q,
                                       jspec.output_padding_q)
    assert jup.hw2_eligible(jspec, thw, thw_f)
    monkeypatch.setattr(jkb, "fused_decoder_block",
                        functools.partial(jkb.fused_decoder_block, interpret=True))
    monkeypatch.setattr(jup, "hw2_upsample", functools.partial(jup.hw2_upsample, interpret=True))
    monkeypatch.setattr(jup, "HW2_SKIP_KERNEL", True)
    want = np.asarray(jmvit._decoder_kernel_forward(jnp.asarray(x), params, jspec, thw, thw_f))

    calls = []
    orig = kup.hw2_upsample
    monkeypatch.setattr(kup, "hw2_upsample", lambda *a: calls.append(1) or orig(*a))
    monkeypatch.setattr(kup, "HW2_SKIP_KERNEL", True)
    assert tmvit.block_route(block.spec, None, thw) == "decoder_block"
    with torch.no_grad():
        got, got_thw = block(torch.from_numpy(x), thw)
    assert calls == [1] and got_thw == tuple(thw_f)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)


def test_flagship_hw2_sites():
    """With the switch on, the flagship's eval forward takes B9a at d2 and d3
    (B5's route, stride (1,2,2)); d1's skip is on the K1+K2 route, where the
    JAX package does not read the switch either."""
    spec = tcsts.build_spec(presets.flagship_cfg())
    thw, sites = spec.fusion_thw, []
    for i, s in enumerate(spec.decoder_blocks):
        if tmvit.block_route(s, None, thw) == "decoder_block" and tuple(s.stride_q) == (1, 2, 2):
            sites.append(i + 1)
        thw = tmvit._static_upsample_out(thw, s.kernel_q, s.stride_q, s.padding_q,
                                         s.output_padding_q)
    assert sites == [2, 3]


# tests/test_fused_block.py:23-25 (dim, dim_out, heads, thw, stride_kv), batch 1;
# the block-diagonal variant needs Lk % 128 == 0, so its 4-head rows take two
# frames (Lk 128) and its 8-head row is the same (Lk 256)
HG_CASES = [
    (384, 384, 4, (1, 16, 16), (1, 2, 2)),
    (384, 768, 4, (1, 16, 16), (1, 2, 2)),
    (768, 768, 8, (1, 16, 16), (1, 1, 1)),
]
BD_CASES = [
    (384, 384, 4, (2, 16, 16), (1, 2, 2)),
    (384, 768, 4, (2, 16, 16), (1, 2, 2)),
    (768, 768, 8, (1, 16, 16), (1, 1, 1)),
]


@pytest.mark.parametrize("variant,dim,dim_out,heads,thw,skv",
                         [("hg", *c) for c in HG_CASES] + [("bd", *c) for c in BD_CASES])
def test_multihead_block_matches_pallas(variant, dim, dim_out, heads, thw, skv):
    jspec, params, block = _pair(dim, dim_out, heads, (), skv, seed=2)
    l = int(np.prod(thw))
    x = np.random.default_rng(2).standard_normal((1, l, dim)).astype(np.float32)
    xj = jnp.asarray(x)
    k, v = jmvit._pooled_kv(params, jspec, xj, thw)
    assert variant != "bd" or k.shape[2] % 128 == 0
    want = np.asarray(jkb.fused_block(xj, k, v, params, jspec, interpret=True, variant=variant))
    # the eval dispatch keeps JAX's two-head cap; ab_block reaches the kernel
    assert tmvit.block_route(block.spec, None, thw) == "composite"
    calls = []
    orig = kb.fused_block
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kb, "fused_block", lambda *a: calls.append(a[1].shape) or orig(*a))
        with torch.no_grad():
            got, got_thw = block.forward_block(torch.from_numpy(x), thw)
            ref, _ = block.forward_composite(torch.from_numpy(x), thw)
    assert calls == [(1, heads, k.shape[2], dim // heads)] and got_thw == thw
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)


def test_decoder_whole_vol_matches_port(monkeypatch):
    """B5's ``whole_vol`` mode (``DEC_VOL_VIEWS``, a mode of the
    ``pallas_call`` at block.py:1222): the JAX kernel with the whole padded
    coarse volume as one block, in interpret mode, at a d3-like shape
    (stride (1,2,2), dim 384), against the port's B5."""
    thw = (2, 8, 8)
    jspec, params, block = _pair(384, 192, 4, (1, 2, 2), (1, 2, 2), upsample=True, seed=7)
    x = (np.random.default_rng(7).standard_normal((1, 128, 384)) * 0.5).astype(np.float32)
    xj = jnp.asarray(x)
    monkeypatch.setattr(jkb, "DEC_VOL_VIEWS", True)
    modes = []
    orig = jkb._decoder_kernel
    monkeypatch.setattr(jkb, "_decoder_kernel",
                        lambda *a, **kw: modes.append(kw["whole_vol"]) or orig(*a, **kw))
    k, v = jmvit._pooled_kv(params, jspec, xj, thw)
    q5 = jmvit._coarse_q_slots(params, jspec, xj, thw)
    thw_f = jmvit._static_upsample_out(thw, jspec.kernel_q, jspec.stride_q, jspec.padding_q,
                                       jspec.output_padding_q)
    skip, _ = jmvit.upsample_tokens_trilinear(xj, thw, jspec.stride_q)
    want = np.asarray(jkb.fused_decoder_block(q5, skip, k, v, params, jspec, thw_f,
                                              interpret=True))
    assert modes and all(modes)  # every grid step ran in whole_vol mode
    assert tmvit.block_route(block.spec, None, thw) == "decoder_block"
    with torch.no_grad():
        got, got_thw = block(torch.from_numpy(x), thw)
    assert got_thw == tuple(thw_f)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)


# --- the tools on the CPU -----------------------------------------------------------


def test_ab_flags_switches_restore():
    from csts_torch.models import csts
    from csts_torch.ops import resize

    reg = ab_flags.flag_registry()
    assert reg == {"head_commute": (csts, "HEAD_COMMUTE"),
                   "split_resize": (resize, "SPLIT_AXES_T_FIRST"),
                   "t2_skip": (kup, "T2_SKIP_KERNEL"), "hw2_skip": (kup, "HW2_SKIP_KERNEL")}
    kup.HW2_SKIP_KERNEL = True  # a default that flips: base still forces it off
    try:
        with ab_flags.flags("base"):
            assert kup.HW2_SKIP_KERNEL is False
        with ab_flags.flags("hw2_skip"):
            assert kup.HW2_SKIP_KERNEL is True
        assert kup.HW2_SKIP_KERNEL is True
        with pytest.raises(ValueError, match="unknown"):
            with ab_flags.flags("nope"):
                pass
    finally:
        kup.HW2_SKIP_KERNEL = False


def test_ab_block_cpu_small(capsys):
    assert ab_block.main(["--device", "cpu", "--small", "--iters", "1", "--batch", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu")
    rows = [ln for ln in lines if "composite=" in ln]
    assert len(rows) == len(ab_block.SMALL)
    assert all("block=" in ln and "x)" in ln for ln in rows)


def test_ab_block_small_routes_agree():
    """Both routes of every narrow stack on the CPU (bf16 twins): the block
    route goes through ``kb.fused_block`` once a block and stays within the
    bf16 bar of the composite."""
    res = ab_block.run(ab_block.SMALL, 1, 1, "cpu", log=lambda s: None)
    assert [r["heads"] for r in res] == [1, 2, 4, 8, 4]
    for r in res:
        assert r["max_abs_diff"] < 0.1, r


def test_ab_flags_cpu_small(capsys):
    argv = ["--device", "cpu", "--small", "--batch", "1", "--iters", "1", "--rounds", "1"]
    assert ab_flags.main(argv) == 0
    out = capsys.readouterr().out
    assert "base" in out and "hw2_skip" in out and "clips/s" in out and "x vs base" in out
    assert kup.HW2_SKIP_KERNEL is False


def test_profile_forward_cpu_small(tmp_path):
    out = tmp_path / "profile.json"
    argv = ["--device", "cpu", "--small", "--batch", "1", "--iters", "1", "--out", str(out)]
    assert profile_forward.main(argv) == 0
    res = json.loads(out.read_text())
    assert res["device"] == "cpu" and res["device_busy_ms"] == 0.0
    assert profile_forward.family("void csts::fb::block_mma_kernel<0, 1, 12, 12, 128>") \
        == "B3-B5, B9b/c whole blocks"
    assert profile_forward.family("hw2_upsample_kernel<bf16, 8>") == "B9a hw2_upsample"


def test_window_losses_counts_a_lost_prefix(tmp_path):
    seq = ("a", "b", "c", "d")
    res = profile_forward.window_losses([seq, seq[2:], seq, ("a", "c", "d"), seq])
    assert res == {"windows": 5, "kernels": 4, "differ": 2, "prefix_lost": [2, -1]}
    out = tmp_path / "profile.json"
    argv = ["--device", "cpu", "--small", "--batch", "1", "--iters", "1", "--windows", "2",
            "--out", str(out)]
    assert profile_forward.main(argv) == 0
    rows = json.loads(out.read_text())["windows"]
    assert [r["margin_ms"] for r in rows] == [0.0, profile_forward.WINDOW_MARGIN_S * 1e3]
    assert all(r["windows"] == 2 and r["differ"] == 0 for r in rows)


def test_agreed_reading_takes_two_whole_windows_that_agree():
    calls = 20
    windows = [(0.0, {}, 0),                     # no activity at all
               (0.5, {"k": 15}, 5),              # a lost prefix: not whole calls
               (1.0, {"k": 20, "m": 40}, 0),
               (0.8, {"k": 20, "m": 40}, 1),     # whole calls, but a launch lost
               (1.1, {"k": 20}, 0),              # whole, but other counts
               (0.9, {"k": 20, "m": 40}, 0),     # agrees with the third
               (5.0, {"k": 20, "m": 40}, 0)]
    seen = []

    def lazy():
        for w in windows:
            seen.append(w)
            yield w

    assert profile_forward.agreed_reading(lazy(), calls) == (1.0, {"k": 1, "m": 2})
    assert len(seen) == 6  # no window is traced after the two that agree
    assert profile_forward.agreed_reading(iter(windows[:5]), calls) == (None, None)
    assert not profile_forward.whole_window(0.0, {}, calls)
    assert not profile_forward.whole_window(0.5, {"k": 20}, calls, lost=1)
    assert not profile_forward.whole_window(0.5, {"k": 20, "m": 10}, calls)
    assert profile_forward.whole_window(0.5, {"k": 20, "m": 60}, calls)


class _Event:
    """A profiler event as ``_KinetoEvent`` gives it (the fields read)."""

    def __init__(self, kind, name, corr, start, end, device=False):
        self._v = (kind, name, corr, start, end, device)

    def is_user_annotation(self):
        return self._v[0] == "user_annotation"

    def name(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def end_ns(self):
        return self._v[4]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[5] else torch.autograd.DeviceType.CPU


def test_window_record_counts_lost_launches_and_gaps():
    from types import SimpleNamespace

    call = 1_000_000
    events = [
        _Event("cpu_op", "aten::mm", 0, call + 1_000, call + 9_000),
        _Event("cuda_runtime", "cudaLaunchKernel", 7, call + 2_000, call + 3_000),
        _Event("cuda_runtime", "cudaMemcpyAsync", 8, call + 4_000, call + 5_000),
        _Event("cuda_driver", "cuLaunchKernelEx", 9, call + 6_000, call + 7_000),
        _Event("cuda_runtime", "cudaStreamSynchronize", 10, call + 8_000, call + 9_000),
        _Event("kernel", "gemm", 7, call + 7_000, call + 20_000, device=True),
        _Event("gpu_memcpy", "Memcpy DtoD", 8, call + 21_000, call + 22_000, device=True),
        _Event("user_annotation", "forward", 0, call, call + 23_000, device=True),
    ]
    results = SimpleNamespace(events=lambda: events, trace_start_ns=lambda: call - 20_000_000)
    rec = profile_forward._window_record(SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=results)), call, 0.02)
    # the driver launch (9) has no activity; the synchronisation is no launch
    assert (rec["launches"], rec["activities"], rec["lost"]) == (3, 2, 1)
    assert rec["least_gap_us"] == 5.0  # gemm 5 µs after its launch, the copy 17 µs
    assert rec["window_us"] == -20_000.0
    assert rec["margin_ms"] == 20.0 and rec["recorded"]
    assert rec["priming_lost"] == 0
    # the first launch primes the window: its activity is not the call's
    rec = profile_forward._window_record(SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=results)), call, 0.02, priming=1)
    assert (rec["launches"], rec["activities"], rec["lost"], rec["priming_lost"]) == (2, 1, 1, 0)
    assert rec["least_gap_us"] == 17.0
    gone = profile_forward._window_record(SimpleNamespace(profiler=None), call, 0.02)
    assert not gone["recorded"] and "AttributeError" in gone["why"]


def test_export_windows_cpu_small(tmp_path):
    out = tmp_path / "profile.json"
    argv = ["--device", "cpu", "--small", "--batch", "1", "--iters", "1", "--export-windows", "1",
            "--out", str(out)]
    assert profile_forward.main(argv) == 0
    rows = json.loads(out.read_text())["export_windows"]
    assert [(r["when"], r["priming"]) for r in rows] == [
        (w, p) for w in ("before export", "after export")
        for p in (0, profile_forward.PRIMING_LAUNCHES)]
    assert all(r["lost"] is None for r in rows)  # no device, no counts

"""The port's serving slice against the JAX package on the CPU.

* ``GazePredictor.from_checkpoint`` on a JAX-written TrainState npz (EMA off
  and on) against ``csts_tpu.serving.GazePredictor.from_checkpoint``;
  heatmaps within 1e-5 (the predictor bar of ``tests/test_torch_model.py``),
  gaze points equal; the npz the port's own trainer writes; the refusals.
* ``preprocess_frames`` against the JAX predictor's on seeded uint8 frames.
* The bucket's device padding bit-equal to the host padding it replaced.
* The seven kernel custom ops under ``torch.library.opcheck``.
* ``export_compiled`` -> ``from_exported`` within 1e-6 of the live
  predictor (``tests/test_end_to_end.py``'s export round trip), and the
  loader importing no model or config code.
* ``csts_torch.serving_server``: ``MicroBatcher`` parity, coalescing, bad
  shapes, a failing group and ``close()`` on a full queue; the HTTP service
  against ``csts_tpu``'s on the same weights.
* The three serving tools' ``--help``.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as graft
from csts_tpu.models import csts as jcsts
from csts_tpu.serving import GazePredictor as JaxPredictor
from csts_tpu.serving_server import GazeHTTPServer as JaxHTTPServer
from csts_tpu.train import step as jstep
from csts_tpu.utils import checkpoint as jcu
from csts_torch import presets
from csts_torch.convert.from_jax import state_dict_from_jax
from csts_torch.kernels import attention as ka
from csts_torch.kernels import block as kb
from csts_torch.kernels import upsample as kup
from csts_torch.models.csts import build_spec
from csts_torch.serving import GazePredictor
from csts_torch.serving_server import GazeHTTPServer, MicroBatcher
from csts_torch.train import step as tstep
from csts_torch.utils import checkpoint as tcu

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = 32
FRAMES = 8
BUCKET = 2
HEAT_TOL = 1e-5  # tests/test_torch_model.py's predictor bar
EXPORT_TOL = 1e-6  # tests/test_end_to_end.py's export round trip


def _cfg_pair(ema: float = 0.9):
    jcfg, tcfg = graft._small_cfg(BUCKET), presets.small_cfg(BUCKET)
    for c in (jcfg, tcfg):
        c.SOLVER.EMA_DECAY = ema
    return jcfg, tcfg


def make_clips(rng, n):
    video = rng.standard_normal((n, FRAMES, CROP, CROP, 3)).astype(np.float32)
    audio = rng.standard_normal((n, FRAMES, CROP, CROP, 1)).astype(np.float32)
    return video, audio


@pytest.fixture(scope="module")
def jax_npz(tmp_path_factory):
    """A JAX TrainState npz written with EMA on; the EMA leaves are the
    params scaled, so that serving them differs from serving the params."""
    jcfg, _ = _cfg_pair()
    state, _ = jstep.create_train_state(jcfg, jcsts.build_spec(jcfg), jax.random.PRNGKey(0))
    ema = jax.tree_util.tree_map(lambda x: x * 0.9 + 0.01, state.params)
    state = jstep.TrainState(state.params, state.opt_state, state.step, ema)
    host = jax.tree_util.tree_map(np.asarray, state)
    return jcu.save_checkpoint(str(tmp_path_factory.mktemp("npz")), host, epoch=0, cfg=jcfg)


@pytest.fixture(scope="module")
def pairs(jax_npz):
    """{use_ema: (JAX predictor, port predictor)} on the same npz."""
    jcfg, tcfg = _cfg_pair()
    return {ema: (JaxPredictor.from_checkpoint(jcfg, jax_npz, use_ema=ema,
                                               batch_sizes=(BUCKET,)),
                  GazePredictor.from_checkpoint(tcfg, jax_npz, use_ema=ema,
                                                batch_sizes=(BUCKET,), device="cpu"))
            for ema in (False, True)}


@pytest.fixture(scope="module")
def predictor():
    _, tcfg = _cfg_pair(0.0)
    return GazePredictor.from_checkpoint(tcfg, None, batch_sizes=(4,), device="cpu")


# ----------------------------------------------------------------------------------
# from_checkpoint
# ----------------------------------------------------------------------------------


@pytest.mark.parametrize("use_ema", [False, True], ids=["params", "ema"])
def test_from_checkpoint_npz_matches_jax(pairs, use_ema):
    jpred, tpred = pairs[use_ema]
    rng = np.random.default_rng(3)
    video, audio = make_clips(rng, BUCKET)
    want, got = jpred.predict(video, audio), tpred.predict(video, audio)
    np.testing.assert_allclose(got["heatmaps"], want["heatmaps"], atol=HEAT_TOL, rtol=0)
    np.testing.assert_array_equal(got["gaze_xy"], want["gaze_xy"])
    # the served weights are the npz's params or its EMA leaves, leaf for leaf
    leaves = jpred.params
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, leaves))
    for name, p in tpred.model.state_dict().items():
        if name in sd:
            np.testing.assert_array_equal(p.numpy(), sd[name].numpy(), err_msg=name)


def test_from_checkpoint_serves_the_port_trainers_npz(tmp_path):
    """The npz TrainState the port's trainer writes (EMA on): its params, and
    its EMA weights with use_ema."""
    _, tcfg = _cfg_pair()
    state = tstep.create_train_state(tcfg, build_spec(tcfg), torch.Generator().manual_seed(5),
                                     device="cpu")
    for v in state.ema.values():
        v.mul_(0.5)
    path = tcu.save_checkpoint(str(tmp_path), state, 0, tcfg)
    for use_ema, want in ((False, dict(state.model.named_parameters())), (True, state.ema)):
        pred = GazePredictor.from_checkpoint(tcfg, path, use_ema=use_ema, device="cpu")
        got = dict(pred.model.named_parameters())
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            torch.testing.assert_close(got[name], w.detach(), rtol=0, atol=0, msg=name)


def test_from_checkpoint_refusals(jax_npz, tmp_path):
    """use_ema without SOLVER.EMA_DECAY, on an archive without EMA leaves, or
    on a state dict file raises, as the JAX predictor's asserts do."""
    _, no_ema_cfg = _cfg_pair(0.0)
    with pytest.raises(ValueError, match="EMA_DECAY"):
        GazePredictor.from_checkpoint(no_ema_cfg, jax_npz, use_ema=True, device="cpu")
    state = tstep.create_train_state(no_ema_cfg, build_spec(no_ema_cfg),
                                     torch.Generator().manual_seed(0), device="cpu")
    plain = tcu.save_checkpoint(str(tmp_path / "plain"), state, 0, no_ema_cfg)
    _, ema_cfg = _cfg_pair()
    with pytest.raises(ValueError, match="no EMA"):
        GazePredictor.from_checkpoint(ema_cfg, plain, use_ema=True, device="cpu")
    pt = str(tmp_path / "w.pt")
    torch.save(state.model.state_dict(), pt)
    with pytest.raises(ValueError, match="npz"):
        GazePredictor.from_checkpoint(ema_cfg, pt, use_ema=True, device="cpu")
    with pytest.raises(ValueError, match="npz"):
        GazePredictor.from_checkpoint(ema_cfg, None, use_ema=True, device="cpu")


def test_from_checkpoint_none_is_the_seeded_init(predictor):
    """No path: the port's seeded init (the JAX init comes from a PRNGKey the
    port cannot reproduce, so only shapes are compared), the same weights on
    every call, and finite heatmaps of the expected shape."""
    jcfg, tcfg = _cfg_pair(0.0)
    jax_sd = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jcsts.csts_init(jax.random.PRNGKey(0), jcsts.build_spec(jcfg))))
    sd = predictor.model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in jax_sd.items()}
    again = GazePredictor.from_checkpoint(tcfg, None, device="cpu").model.state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    out = predictor.predict(*make_clips(np.random.default_rng(0), 3))
    assert out["heatmaps"].shape == (3, FRAMES, CROP // 4, CROP // 4)
    assert out["gaze_xy"].shape == (3, FRAMES, 2)
    assert np.isfinite(out["heatmaps"]).all()
    np.testing.assert_allclose(out["heatmaps"].reshape(3, FRAMES, -1).sum(-1), 1.0, atol=1e-5)


# ----------------------------------------------------------------------------------
# preprocess_frames and the device padding
# ----------------------------------------------------------------------------------


# The bar where the short side is scaled to the crop: the resize's float bar
# of tests/test_torch_data.py (1e-4 on [0, 1] values: cv2's float path, which
# the JAX package uses, rounds its weights; the port's resize does not)
# over the smallest std, which the normalization divides by. Where the short
# side is the crop there is no resize and the bar is 1e-5.
RESIZE_TOL = 1e-4 / 0.225


@pytest.mark.parametrize("hw,tol", [((32, 40), 1e-5), ((48, 64), RESIZE_TOL),
                                    ((256, 320), RESIZE_TOL), ((360, 480), RESIZE_TOL)],
                         ids=["no_resize", "48x64", "256x320", "360x480"])
def test_preprocess_frames_matches_jax(pairs, hw, tol):
    """Raw uint8 frames: the port's scale, centre crop and normalization
    against the JAX predictor's."""
    jpred, tpred = pairs[False]
    assert min(tpred._std) == pytest.approx(0.225)
    frames = np.random.default_rng(hw[0]).integers(0, 256, (FRAMES, *hw, 3), dtype=np.uint8)
    got, want = tpred.preprocess_frames(frames), jpred.preprocess_frames(frames)
    assert got.shape == want.shape == (FRAMES, CROP, CROP, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


@pytest.mark.parametrize("n", [1, 3, 4, 6], ids=["n1", "n3", "bucket", "above"])
def test_device_padding_equals_host_padding(predictor, n):
    """The bucket's buffers hold the request and the last clip repeated,
    bit for bit what the host's np.concatenate/np.repeat padding gave, and
    the heatmaps equal the forward over that host-padded batch. Above the
    largest bucket one forward runs at n."""
    video, audio = make_clips(np.random.default_rng(20 + n), n)
    bucket = max(n, 4)
    pad = bucket - n
    host_v = np.concatenate([video, np.repeat(video[-1:], pad, 0)])
    host_a = np.concatenate([audio, np.repeat(audio[-1:], pad, 0)])
    out = predictor.predict(video, audio)
    want = predictor.forward(torch.from_numpy(host_v), torch.from_numpy(host_a))
    np.testing.assert_array_equal(out["heatmaps"], want.numpy()[:n, ..., 0])
    if n <= 4:
        slot = predictor._slots[4]
        np.testing.assert_array_equal(slot.video.numpy(), host_v)
        np.testing.assert_array_equal(slot.audio.numpy(), host_a)


def test_predict_refuses_integer_clips(predictor):
    video, audio = make_clips(np.random.default_rng(0), 1)
    with pytest.raises(ValueError, match="preprocess_frames"):
        predictor.predict(video.astype(np.uint8), audio)


# ----------------------------------------------------------------------------------
# the kernels as custom ops
# ----------------------------------------------------------------------------------


def _op_args(name):
    """CPU fp32 arguments of each op at small shapes (C 16, hd 16, hidden 64)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.5

    c, hid = 16, 64
    tail = [1 + r(c), r(c), r(hid, c), r(hid), r(c, hid), r(c), None, None]
    kv = [r(1, 1, 8, c), r(1, 1, 8, c)]
    conv = [r(c, 1, 3, 3, 3), 1 + r(c), r(c), r(c, c), r(c)]
    return {
        "fused_attention": (r(2, 2, 16, 8), r(2, 2, 12, 8), r(2, 2, 12, 8), 0.35, r(16, 12)),
        "fused_mlp_tail": (r(2, 8, c), *tail[:4], r(32, hid), r(32), r(32, c), r(32)),
        "t2_upsample": (r(2, 32, 8), [2, 4, 4]),
        "hw2_upsample": (r(2, 32, 8), [2, 4, 4]),
        "fused_block": (r(1, 32, c), *kv, 0.25, 1 + r(c), r(c), r(c, c), r(c), r(c, c), r(c),
                        *tail, None),
        "fused_pool_block": (r(1, 32, c), [2, 4, 4], r(1, 8, c), *kv, 0.25, *conv, *tail),
        "fused_decoder_block": (r(1, 8, c), [2, 2, 2], [1, 2, 2], r(1, 32, c), *kv, 0.25,
                                *conv, *tail),
    }[name]


OPS = ("fused_attention", "fused_mlp_tail", "t2_upsample", "hw2_upsample", "fused_block",
       "fused_pool_block", "fused_decoder_block")
WRAPPERS = {"fused_attention": ka, "fused_mlp_tail": kb, "t2_upsample": kup,
            "hw2_upsample": kup, "fused_block": kb, "fused_pool_block": kb,
            "fused_decoder_block": kb}


@pytest.mark.parametrize("name", OPS)
def test_kernel_op_opcheck(name):
    """Schema, autograd registration, fake (meta) implementation and AOT
    dispatch of each op on CPU tensors, and the wrapper (which calls the op)
    equal to the plain twin."""
    op = getattr(torch.ops.csts_torch, name).default
    args = _op_args(name)
    result = torch.library.opcheck(op, args)
    assert all(v == "SUCCESS" for v in result.values()), result
    wrapper = getattr(WRAPPERS[name], name)
    plain = getattr(WRAPPERS[name], f"{name}_plain")
    torch.testing.assert_close(wrapper(*args), plain(*args), rtol=0, atol=0)


@pytest.mark.parametrize("name", OPS)
def test_kernel_wrapper_keeps_cpu_autograd(name):
    """The ops have no autograd formula: on the CPU an input that wants a
    gradient sends the wrapper around the op, so gradients flow: equal to
    the plain twin's autograd, which K2's and B3's Functions recompute and
    the others run directly; K1 takes its Function, the JAX package's
    custom VJP, whose backward at a masked site is the plain recompute
    (``ka.masked_attention_bwd_plain``), and equals that bit for bit."""
    wrapper = getattr(WRAPPERS[name], name)
    plain = getattr(WRAPPERS[name], f"{name}_plain")
    grads = []
    for fn in (wrapper, plain):
        args = list(_op_args(name))
        leaf = args[0].clone().requires_grad_()
        args[0] = leaf
        fn(*args).square().sum().backward()
        grads.append(leaf.grad)
    if name == "fused_attention":
        q, k, v, scale, mask = _op_args(name)
        out = ka.fused_attention_plain(q, k, v, scale, mask)
        want = ka.masked_attention_bwd_plain(q, k, v, mask, 2 * out, scale)[0]
        torch.testing.assert_close(grads[0], want, rtol=0, atol=0)
        torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-4)
        return
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


# ----------------------------------------------------------------------------------
# the artifact: export_compiled -> from_exported
# ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def artifact(pairs, tmp_path_factory):
    _, tpred = pairs[False]
    path = str(tmp_path_factory.mktemp("exported"))
    tpred.export_compiled(path)
    return path


# the op calls of small_cfg's forward: B3 at the 1-head blocks, B4 at the
# Q-pool blocks, B5 at the decoder's kernel-route blocks, K1+K2 elsewhere
def _kernel_calls(model) -> dict:
    calls = {name: 0 for name in OPS}
    originals = {name: getattr(WRAPPERS[name], name) for name in OPS}

    def counting(name):
        def f(*a, **k):
            calls[name] += 1
            return originals[name](*a, **k)
        return f
    try:
        for name in OPS:
            setattr(WRAPPERS[name], name, counting(name))
        with torch.inference_mode():
            model(*(torch.from_numpy(x) for x in make_clips(np.random.default_rng(0), BUCKET)))
    finally:
        for name in OPS:
            setattr(WRAPPERS[name], name, originals[name])
    return calls


def test_export_roundtrip(pairs, artifact):
    """The reloaded programs reproduce the live predictor within 1e-6 with
    the same gaze points; each program calls the kernels as custom ops as
    often as the eager forward calls their wrappers, and holds no weights;
    preprocess_frames works from meta.json alone."""
    _, tpred = pairs[False]
    files = sorted(os.listdir(artifact))
    assert files == ["forward_b2.pt2", "meta.json", "params.pt"], files
    assert os.path.getsize(os.path.join(artifact, "forward_b2.pt2")) < \
        os.path.getsize(os.path.join(artifact, "params.pt"))
    meta = json.load(open(os.path.join(artifact, "meta.json")))
    assert meta["platforms"] == ["cpu"] and meta["batch_sizes"] == [BUCKET]
    assert (meta["num_frames"], meta["crop_size"]) == (FRAMES, CROP)

    program = torch.export.load(os.path.join(artifact, "forward_b2.pt2"))
    in_graph = {name: 0 for name in OPS}
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("csts_torch."):
            in_graph[str(node.target).split(".")[1]] += 1
    assert in_graph == _kernel_calls(tpred.model)
    assert in_graph["fused_attention"] > 0 and in_graph["fused_pool_block"] > 0

    reloaded = GazePredictor.from_exported(artifact, device="cpu")
    assert reloaded.cfg is None and reloaded.batch_sizes == [BUCKET]
    rng = np.random.default_rng(0)
    for n in (1, 2):
        video, audio = make_clips(rng, n)
        live, out = tpred.predict(video, audio), reloaded.predict(video, audio)
        np.testing.assert_allclose(out["heatmaps"], live["heatmaps"], atol=EXPORT_TOL, rtol=0)
        np.testing.assert_array_equal(out["gaze_xy"], live["gaze_xy"])
    frames = rng.integers(0, 255, (FRAMES, 40, 56, 3), dtype=np.uint8)
    np.testing.assert_array_equal(reloaded.preprocess_frames(frames),
                                  tpred.preprocess_frames(frames))
    with pytest.raises(ValueError, match="programs"):
        reloaded.predict(*make_clips(rng, 3))
    with pytest.raises(ValueError, match="exported for"):
        GazePredictor.from_exported(artifact, device="meta")


def test_from_exported_loads_no_model_code(artifact):
    """A fresh interpreter loads and runs the artifact without importing
    csts_torch.models, csts_torch.config, jax or csts_tpu."""
    code = (
        "import sys, numpy as np\n"
        "from csts_torch.serving import GazePredictor\n"
        f"p = GazePredictor.from_exported({artifact!r}, device='cpu')\n"
        "rng = np.random.default_rng(0)\n"
        f"v = rng.standard_normal((1, {FRAMES}, {CROP}, {CROP}, 3)).astype(np.float32)\n"
        f"a = rng.standard_normal((1, {FRAMES}, {CROP}, {CROP}, 1)).astype(np.float32)\n"
        "assert np.isfinite(p.predict(v, a)['heatmaps']).all()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'csts_tpu') or "
        "m.startswith(('csts_torch.models', 'csts_torch.config')))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


# ----------------------------------------------------------------------------------
# the micro-batcher and the HTTP service
# ----------------------------------------------------------------------------------


def test_batcher_parity_and_coalescing(predictor):
    """Concurrent submits get their own clip's result, equal to one batched
    predict, coalesced into fewer predictor calls than requests."""
    clips = [tuple(x[0] for x in make_clips(np.random.default_rng(i), 1)) for i in range(8)]
    direct = predictor.predict(np.stack([v for v, _ in clips]), np.stack([a for _, a in clips]))
    batcher = MicroBatcher(predictor, max_wait_ms=200.0)
    try:
        futs = [None] * len(clips)
        barrier = threading.Barrier(len(clips))

        def worker(i):
            barrier.wait()
            futs[i] = batcher.submit(*clips[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(clips))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = [f.result(timeout=120) for f in futs]
    finally:
        batcher.close()
    for i, res in enumerate(results):
        np.testing.assert_allclose(res["heatmaps"], direct["heatmaps"][i], atol=1e-6)
        np.testing.assert_array_equal(res["gaze_xy"], direct["gaze_xy"][i])
    st = batcher.stats()
    assert st["requests"] == 8 and st["clips"] == 8 and st["errors"] == 0
    assert st["batches"] <= 4 and st["mean_batch_occupancy"] >= 2.0
    assert st["latency_p50_ms"] > 0 and st["latency_p99_ms"] >= st["latency_p50_ms"]


def test_batcher_rejects_bad_shapes(predictor):
    rng = np.random.default_rng(1)
    batcher = MicroBatcher(predictor, max_wait_ms=1.0)
    try:
        v, a = (x[0] for x in make_clips(rng, 1))
        good = batcher.submit(v, a)
        assert good.result(timeout=120)["heatmaps"].shape == (FRAMES, CROP // 4, CROP // 4)
        with pytest.raises(ValueError):
            batcher.submit(v[None], a[None]).result(timeout=5)
        with pytest.raises(ValueError):
            batcher.submit(v[:4], a[:4]).result(timeout=5)
        assert np.isfinite(batcher.submit(v, a).result(timeout=120)["heatmaps"]).all()
    finally:
        batcher.close()
    with pytest.raises(RuntimeError):
        batcher.submit(v, a)


class _StubPredictor:
    """A predictor whose predict blocks until released, or raises."""

    batch_sizes = (2,)

    def __init__(self, fail=None):
        self.release = threading.Event()
        self.entered = threading.Event()
        self.fail = fail

    def predict(self, video, audio):
        self.entered.set()
        self.release.wait(30)
        if self.fail is not None:
            raise self.fail
        n = video.shape[0]
        return {"heatmaps": np.zeros((n, 2, 4, 4), np.float32),
                "gaze_xy": np.zeros((n, 2, 2), np.float32)}


def test_batcher_close_on_a_full_queue_returns():
    """With the dispatcher busy and the queue full, close() returns within
    its timeout and fails every request it never ran with RuntimeError; the
    group in flight still gets its answer."""
    pred = _StubPredictor()
    batcher = MicroBatcher(pred, max_wait_ms=0.0, max_queue=3)
    clip = (np.zeros((2, 4, 4, 3), np.float32), np.zeros((2, 4, 4, 1), np.float32))
    first = batcher.submit(*clip)
    assert pred.entered.wait(30)
    queued = [batcher.submit(*clip) for _ in range(3)]
    with pytest.raises(RuntimeError, match="full"):
        batcher.submit(*clip).result(timeout=1)
    t0 = time.monotonic()
    batcher.close(timeout=0.5)
    assert time.monotonic() - t0 < 5.0
    for fut in queued:
        with pytest.raises(RuntimeError, match="closed"):
            fut.result(timeout=1)
    pred.release.set()
    assert first.result(timeout=30)["heatmaps"].shape == (2, 4, 4)
    batcher._thread.join(timeout=30)
    assert not batcher._thread.is_alive()
    with pytest.raises(RuntimeError):
        batcher.submit(*clip)


def test_batcher_fails_a_group_on_an_exception():
    pred = _StubPredictor(fail=KeyError("boom"))
    pred.release.set()
    batcher = MicroBatcher(pred, max_wait_ms=100.0)
    clip = (np.zeros((2, 4, 4, 3), np.float32), np.zeros((2, 4, 4, 1), np.float32))
    try:
        futs = [batcher.submit(*clip) for _ in range(2)]
        for fut in futs:
            with pytest.raises(KeyError):
                fut.result(timeout=30)
        assert batcher.stats()["errors"] == 2
    finally:
        batcher.close()


def _post(base, **arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"{base}/predict", data=buf.getvalue(), method="POST")
    return np.load(io.BytesIO(urllib.request.urlopen(req, timeout=300).read()))


def test_http_roundtrip_matches_jax_server(pairs):
    """Both services on the same npz weights: float and uint8 bodies through
    the port's server against the JAX package's server (heatmaps within
    1e-5, gaze points equal) and against a direct predict; /healthz,
    /stats and a malformed body's 400."""
    jpred, tpred = pairs[False]
    rng = np.random.default_rng(2)
    clips = [tuple(x[0] for x in make_clips(rng, 1)) for _ in range(3)]
    frames = rng.integers(0, 255, (FRAMES, 48, 64, 3), dtype=np.uint8)
    bodies = [dict(video=v, audio=a) for v, a in clips] + [dict(video=frames, audio=clips[0][1])]
    answers = {}
    for name, server in (("jax", JaxHTTPServer(jpred, port=0, max_wait_ms=50.0)),
                         ("port", GazeHTTPServer(tpred, port=0, max_wait_ms=50.0))):
        server.start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            assert urllib.request.urlopen(f"{base}/healthz", timeout=30).read() == b"ok"
            out = [None] * len(bodies)

            def post(i):
                out[i] = _post(base, **bodies[i])

            threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            answers[name] = out
            stats = json.loads(urllib.request.urlopen(f"{base}/stats", timeout=30).read())
            assert stats["requests"] == len(bodies) and stats["errors"] == 0
            assert stats["clips"] == len(bodies) and stats["mean_batch_occupancy"] >= 1.0
            req = urllib.request.Request(f"{base}/predict", data=b"not an npz", method="POST")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=30)
            assert ei.value.code == 400
            assert urllib.request.urlopen(f"{base}/healthz", timeout=30).read() == b"ok"
        finally:
            server.close()
    for theirs, ours in zip(answers["jax"], answers["port"]):
        np.testing.assert_allclose(ours["heatmaps"], theirs["heatmaps"], atol=HEAT_TOL, rtol=0)
        np.testing.assert_array_equal(ours["gaze_xy"], theirs["gaze_xy"])
    direct = tpred.predict(tpred.preprocess_frames(frames)[None], clips[0][1][None])
    np.testing.assert_allclose(answers["port"][-1]["heatmaps"], direct["heatmaps"][0],
                               atol=1e-6)


# ----------------------------------------------------------------------------------
# the tools
# ----------------------------------------------------------------------------------


@pytest.mark.parametrize("tool", ["serve", "export_serving", "bench_serving"])
def test_tool_help(tool, capsys):
    import importlib

    mod = importlib.import_module(f"csts_torch.tools.{tool}")
    with pytest.raises(SystemExit) as ei:
        mod.main(["--help"])
    assert ei.value.code == 0
    assert "usage" in capsys.readouterr().out

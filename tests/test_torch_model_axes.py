"""The model, seq and pipe axes of the port (``csts_torch/parallel/mesh.py``,
``parallel/pipeline.py``) on gloo ranks on the CPU, against one process and
against the JAX package; the counterparts of ``tests/test_pipeline.py`` and
of ``tests/test_train_step.py``'s tensor-parallel checks (:574, :602).

* The cfg -> mesh path: the ranks' layout on (data, pipe, seq, model)
  equal to JAX's ``make_mesh`` over 8 CPU devices, PIPE_MICROBATCHES, the
  divisibility guards.
* The GPipe schedule on two ranks against a plain loop: the forward bit-exact
  and the gradients fp32-close at M = S and M = 2S; the microbatch index.
* ``small_cfg`` at 6 video blocks (v4-v5 the uniform run the encoder
  pipelines), 2 ranks each for pp2, tp2 and sp2: the fp32 eval logits within
  5e-4 of JAX's one-device ``csts_apply`` and within 2e-5 of the port's one
  process (``test_train_step.py:574``'s bar); one training step with
  drop-path 0.2 and the global masks against one process at the whole-step
  bars of ``tests/test_torch_parallel.py``; under tp2 the Megatron leaves
  and their Adam moments still split after the step, and the step
  communicating over the model axis.
* ``GazePredictor(devices=[cpu, cpu])`` behind ``MicroBatcher`` against the
  one-replica predictor (``test_serving_server.py::test_batcher_with_mesh_predictor``).
* dp2 x tp2 on 4 ranks under SOLVER.FSDP (``-m slow``: under DDP).
* ``-m slow``: one step on 4 ranks, pp2 x tp2 and sp2 x tp2; ``run_net``
  training under each axis.
"""

from __future__ import annotations

import os
import pkgutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
import csts_torch
from csts_tpu.models import csts as jcsts
from csts_tpu.parallel import mesh as jmesh
from csts_torch import ops, presets
from csts_torch.config import get_cfg
from csts_torch.convert.from_jax import state_dict_from_jax
from csts_torch.models.csts import CSTS, build_spec, init_params
from csts_torch.parallel import mesh, pipeline
from csts_torch.serving import GazePredictor
from csts_torch.serving_server import MicroBatcher
from csts_torch.train import step as tstep
from test_torch_multiproc import run_ranks
from test_torch_parallel import _assert_grads, _assert_params
from torch_axes_workers import axes_cfg, axes_worker, schedule_worker, whole_grads, whole_params

torch.set_num_threads(2)

BATCH = 4
AXES = ("pipe", "model", "seq")


def _heatmaps(rng, shape):
    hm = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    return hm / hm.sum(axis=(2, 3), keepdims=True)


def _inputs(out, world_batch=BATCH):
    jcfg = graft._small_cfg(world_batch)
    jcfg.MVIT.DEPTH = 6
    jcfg.MVIT.DROPPATH_RATE = 0.2
    jspec = jcsts.build_spec(jcfg)
    params = jcsts.csts_init(jax.random.PRNGKey(0), jspec)
    rng = np.random.default_rng(23)
    batch = {
        "video": rng.standard_normal((world_batch, 8, 32, 32, 3)).astype(np.float32),
        "audio": rng.standard_normal((world_batch, 8, 32, 32, 1)).astype(np.float32),
        "labels_hm": _heatmaps(rng, (world_batch, 8, 8, 8)),
    }
    cfg = axes_cfg(world_batch)
    spec = build_spec(cfg)
    drop = ops.sample_drop_masks(spec.video_blocks, world_batch, torch.Generator().manual_seed(3))
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    torch.save({"sd": sd, "batch": tbatch, "drop": drop}, os.path.join(out, "inputs.pt"))
    return jspec, params, batch, cfg, spec, sd, tbatch, drop


def _one_process(cfg, spec, sd, tbatch, drop) -> dict:
    model = CSTS(spec)
    model.load_state_dict(sd)
    model = model.float().eval()
    with torch.inference_mode():
        logits = model(tbatch["video"], tbatch["audio"])
    state = tstep.create_train_state(cfg, spec, state_dict=sd, device="cpu")
    stats, _ = tstep.make_train_step(cfg, spec, steps_per_epoch=10)(state, tbatch, None, drop=drop)
    return {"logits": logits, "stats": {k: float(v) for k, v in stats.items()},
            "grads": whole_grads(state.model), "params": whole_params(state.model),
            "moments": state.optimizer.moments(), "step": state.step, "lr": state.optimizer.lr}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's one-device eval forward, the port's one process (forward and
    one step) and two ranks of each axis, from one init, batch and masks."""
    out = str(tmp_path_factory.mktemp("axes"))
    jspec, params, batch, cfg, spec, sd, tbatch, drop = _inputs(out)
    jlogits = jax.jit(lambda p, v, a: jcsts.csts_apply(p, jspec, v, a, deterministic=True))(
        params, jnp.asarray(batch["video"]), jnp.asarray(batch["audio"]))
    got = {}
    for axis in AXES:
        d = os.path.join(out, axis)
        os.makedirs(d)
        run_ranks(axes_worker, os.path.join(out, "inputs.pt"), d, {axis: 2}, timeout=240)
        got[axis] = [torch.load(os.path.join(d, f"rank{r}.pt")) for r in range(2)]
    return {"jax": np.asarray(jlogits), "one": _one_process(cfg, spec, sd, tbatch, drop),
            "got": got, "cfg": cfg}


def test_parallel_cfg_builds_mesh():
    """The ranks' layout on (data, pipe, seq, model) is JAX's ``make_mesh``
    over 8 CPU devices (device ids in the place of ranks), the seq and pipe
    axes together included; PIPE_MICROBATCHES reaches the schedule through
    ``mesh_from_cfg``; the guards, which accept every composition of the
    axes that divides the ranks."""
    for kw in ({"pipe_parallel": 2, "model_parallel": 2}, {"seq_parallel": 2},
               {"seq_parallel": 2, "model_parallel": 2}, {"pipe_parallel": 4},
               {"seq_parallel": 2, "pipe_parallel": 2},
               {"seq_parallel": 2, "pipe_parallel": 2, "model_parallel": 2}):
        shape, grid = mesh.layout(8, **kw)
        jm = jmesh.make_mesh(num_devices=8, **kw)
        want = np.vectorize(lambda dev: dev.id)(jm.devices)
        assert dict(zip(jm.axis_names, jm.devices.shape)) == {
            a: shape[a] for a in mesh.AXES if a == mesh.DATA_AXIS or shape[a] > 1}
        np.testing.assert_array_equal(grid.reshape(want.shape), want)
    cfg = get_cfg()
    cfg.PARALLEL.PIPE_MICROBATCHES = 4
    saved = pipeline.MICROBATCHES
    try:
        m = mesh.mesh_from_cfg(cfg)
        assert m.axis_names == ("data",) and pipeline.MICROBATCHES == 4
        assert pipeline.effective_microbatches(2) == 4
        assert pipeline.effective_microbatches(2, 8) == 8
    finally:
        pipeline.MICROBATCHES = saved
    assert pipeline.effective_microbatches(2) == 2 and pipeline.pipe_size() is None
    cfg.NUM_DEVICES, cfg.PARALLEL.PIPE, cfg.PARALLEL.MODEL = 8, 2, 2
    cfg.finalize()
    mesh.check_axes(cfg)
    cfg.PARALLEL.PIPE = 3
    with pytest.raises(AssertionError):
        cfg.finalize()
    with pytest.raises(ValueError, match="divide"):
        mesh.check_axes(cfg)
    cfg.PARALLEL.PIPE, cfg.PARALLEL.SEQ = 1, 2
    mesh.check_axes(cfg)
    # the seq axis composes with the pipe axis (tests/test_torch_axes_compose.py)
    cfg.PARALLEL.PIPE, cfg.PARALLEL.MODEL = 2, 1
    mesh.check_axes(cfg)
    cfg.PARALLEL.MODEL = 2
    mesh.check_axes(cfg)


def test_schedule_matches_sequential_loop(tmp_path):
    """Two stages of two blocks: the forward bit-exact against the loop, the
    input's and the weights' gradients within 1e-5, at M = 2 and M = 4; the
    microbatch index each stage hands its blocks is sample i's i % M."""
    run_ranks(schedule_worker, str(tmp_path), timeout=120)
    for r in range(2):
        res = torch.load(tmp_path / f"schedule{r}.pt")
        ref = res["ref"]
        for M in (2, 4):
            got = res[M]
            assert torch.equal(got["y"], ref["y"]), M
            torch.testing.assert_close(got["dx"], ref["dx"], atol=1e-5, rtol=0)
            for a, b in zip(got["dw"] + got["db"], ref["dw"] + ref["db"]):
                torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
        c = res["consts"]
        want = torch.stack([torch.full((4,), float(2 * c[i % 4])) for i in range(8)])
        torch.testing.assert_close(res["index"], want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("axis", AXES)
def test_forward_matches_jax_and_one_process(runs, axis):
    for res in runs["got"][axis]:
        got = res["logits"].numpy()
        np.testing.assert_allclose(got, runs["jax"], atol=5e-4, rtol=0)
        np.testing.assert_allclose(got, runs["one"]["logits"].numpy(), atol=2e-5, rtol=0)


@pytest.mark.parametrize("axis", AXES)
def test_step_matches_one_process(runs, axis):
    """The global batch's losses and the pre-clip norm within 1e-5
    relative; the gradients and the updated params of every rank at the
    whole-step bars (``test_torch_parallel.py``)."""
    want = runs["one"]
    for res in runs["got"][axis]:
        for k in ("loss", "kldiv_loss", "egonce_loss", "grad_norm"):
            assert res["stats"][k] == pytest.approx(want["stats"][k], rel=1e-5), k
        _assert_grads(res["grads"], want["grads"])
        _assert_params(res["params"], want["params"], 1e-6, want["grads"],
                       runs["cfg"].SOLVER.BASE_LR)


def test_model_axis_leaves_and_moments_stay_split(runs):
    """tp2: every block with heads and hidden width even keeps its half of
    qkv (by heads), proj, fc1 and fc2 after the step, and so do their Adam
    moments; the two ranks' halves make the one-process update (the params
    test above gathers them); the step ran collectives over the model axis."""
    spec = build_spec(runs["cfg"])
    blocks = {f"blocks.{i}": b for i, b in enumerate(spec.video_blocks)}
    blocks.update({f"blocks_audio.{i}": b for i, b in enumerate(spec.audio_blocks)})
    for r, res in enumerate(runs["got"]["model"]):
        assert res["coords"]["model"] == r and res["counts"].get("model", 0) > 0
        split = res["split"]
        for name, b in blocks.items():
            leaf = f"{name}.attn.qkv.weight"
            if b.num_heads % 2:
                assert leaf not in split
                continue
            assert split[leaf][1] == (3 * b.dim // 2, b.dim)
            assert split[f"{name}.attn.proj.weight"][1] == (b.dim, b.dim // 2)
            assert split[f"{name}.mlp.fc1.weight"][1] == (b.hidden_dim // 2, b.dim)
            assert split[f"{name}.mlp.fc2.weight"][1] == (b.dim_out, b.hidden_dim // 2)
        for how, shape, mu, nu in split.values():
            assert shape == mu == nu
        assert len(split) >= 6 * 10
    # the rules name what the ranks split
    rules = mesh.param_sharding_rules(CSTS(spec), model_parallel=2)
    assert {n for n, d in rules.items() if d is not None} == set(runs["got"]["model"][0]["split"])
    assert rules["blocks.1.attn.qkv.weight"] == 0 and rules["blocks.1.mlp.fc2.weight"] == 1
    assert set(mesh.param_sharding_rules(CSTS(spec)).values()) == {None}


def test_pipe_and_seq_plans(runs):
    """pp2 ran its M = 2 microbatches over 2 stages of v4-v5; sp2 ran its
    stripes' gathers; neither split a parameter."""
    for res in runs["got"]["pipe"]:
        assert res["pipe_plan"] == {"S": 2, "M": 2} and res["counts"]["pipe"] > 0
        assert res["split"] == {}
    for res in runs["got"]["seq"]:
        assert res["counts"]["seq"] > 0 and res["split"] == {}
    assert [r["coords"]["pipe"] for r in runs["got"]["pipe"]] == [0, 1]


def test_batcher_with_device_list_predictor():
    """``GazePredictor(devices=[cpu, cpu])``: two replicas, each bucket split
    over them, behind the micro-batcher; the answers equal the one-replica
    predictor's (1e-5) request by request; a bucket that does not divide
    the devices is refused."""
    cfg = presets.small_cfg(2)
    model = CSTS(build_spec(cfg))
    init_params(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    one = GazePredictor(cfg, sd, batch_sizes=(2, 8), device="cpu")
    two = GazePredictor(cfg, sd, batch_sizes=(2, 8), devices=["cpu", "cpu"])
    assert two.devices == [torch.device("cpu")] * 2 and two.batch_sizes == [2, 8]
    assert [r.batch_sizes for r in two._replicas] == [[1, 4], [1, 4]]
    rng = np.random.default_rng(4)
    video = rng.standard_normal((8, 8, 32, 32, 3)).astype(np.float32)
    audio = rng.standard_normal((8, 8, 32, 32, 1)).astype(np.float32)
    direct = one.predict(video, audio)
    for n in (1, 3, 8, 9):
        got = two.predict(video[:n] if n <= 8 else np.concatenate([video, video[:1]]),
                          audio[:n] if n <= 8 else np.concatenate([audio, audio[:1]]))
        k = min(n, 8)
        np.testing.assert_allclose(got["heatmaps"][:k], direct["heatmaps"][:k], atol=1e-5)
    batcher = MicroBatcher(two, max_wait_ms=200.0)
    try:
        futs = [batcher.submit(video[i], audio[i]) for i in range(8)]
        results = [f.result(timeout=300) for f in futs]
    finally:
        batcher.close()
    for i, res in enumerate(results):
        np.testing.assert_allclose(res["heatmaps"], direct["heatmaps"][i], atol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        GazePredictor(cfg, sd, batch_sizes=(1, 8), devices=["cpu", "cpu"])


def test_new_modules_reach_the_isolation_walk():
    """The modules of this slice are in the package walk that
    ``tests/test_torch_isolation.py`` imports in a fresh interpreter and
    parses for forbidden imports."""
    mods = {m.name for m in pkgutil.walk_packages(csts_torch.__path__, "csts_torch.")}
    assert {"csts_torch.parallel.pipeline", "csts_torch.utils.tensorboard",
            "csts_torch.data.preprocess"} <= mods


@pytest.mark.parametrize("fsdp", [pytest.param(False, marks=pytest.mark.slow), True],
                         ids=["ddp", "fsdp"])
def test_four_ranks_data_by_model(tmp_path, fsdp):
    """dp2 x tp2 on four ranks, DDP or SOLVER.FSDP over the data axis (FSDP
    shards the model axis's parts again: JAX's ``fsdp_param_sharding``):
    each rank's stripe of the forward within 2e-5 of one process, one step
    against one process at the whole-step bars, the split leaves and their
    moments still split."""
    _, _, _, cfg, spec, sd, tbatch, drop = _inputs(str(tmp_path))
    cfg.SOLVER.FSDP = fsdp
    want = _one_process(cfg, spec, sd, tbatch, drop)
    run_ranks(axes_worker, str(tmp_path / "inputs.pt"), str(tmp_path), {"model": 2}, "cpu",
              {"FSDP": fsdp}, world=4, timeout=300)
    for r in range(4):
        res = torch.load(tmp_path / f"rank{r}.pt")
        lo, n = res["rows"]
        assert (lo, n) == (2 * res["coords"]["data"], 2) and res["dtensor"] == fsdp
        np.testing.assert_allclose(res["logits"].numpy(), want["logits"][lo:lo + n].numpy(),
                                   atol=2e-5)
        for k in ("loss", "kldiv_loss", "egonce_loss", "grad_norm"):
            assert res["stats"][k] == pytest.approx(want["stats"][k], rel=1e-5), k
        _assert_grads(res["grads"], want["grads"])
        _assert_params(res["params"], want["params"], 1e-6, want["grads"], cfg.SOLVER.BASE_LR)
        assert res["split"] and all(s[1] == s[2] == s[3] for s in res["split"].values())


@pytest.mark.slow
@pytest.mark.parametrize("outer", ["pipe", "seq"])
def test_four_ranks_by_model(tmp_path, outer):
    """pp2 x tp2 and sp2 x tp2 on four ranks: one step against one process
    at the whole-step bars, the forward within 2e-5."""
    _, _, _, cfg, spec, sd, tbatch, drop = _inputs(str(tmp_path))
    want = _one_process(cfg, spec, sd, tbatch, drop)
    run_ranks(axes_worker, str(tmp_path / "inputs.pt"), str(tmp_path), {outer: 2, "model": 2},
              world=4, timeout=400)
    for r in range(4):
        res = torch.load(tmp_path / f"rank{r}.pt")
        np.testing.assert_allclose(res["logits"].numpy(), want["logits"].numpy(), atol=2e-5)
        for k in ("loss", "grad_norm"):
            assert res["stats"][k] == pytest.approx(want["stats"][k], rel=1e-5), k
        _assert_grads(res["grads"], want["grads"])
        _assert_params(res["params"], want["params"], 1e-6, want["grads"], cfg.SOLVER.BASE_LR)
        assert res["counts"][outer] > 0 and res["counts"]["model"] > 0


@pytest.mark.slow
@pytest.mark.parametrize("axis", AXES)
def test_run_net_trains_under_each_axis(tmp_path, axis):
    """``run_net --device cpu NUM_DEVICES 2 PARALLEL.<AXIS> 2`` (two spawned
    ranks, the mesh installed by ``init_from_cfg``) trains an epoch of two
    iterations at global batch 4 on ``small_cfg`` at 6 video blocks and
    tests its npz: the npz within 2·Σlr of one process's run, leaf by leaf
    (the tensor-parallel shards gathered whole by rank 0's save)."""
    from csts_torch.data.synthetic import write_dataset
    from csts_torch.tools import run_net
    from csts_torch.utils import checkpoint as tcu

    prefix, splits = write_dataset(str(tmp_path / "data"), "ego4d", num_clips=8, res=(32, 48),
                                   seed=5)
    yaml_path = tmp_path / "cfg.yaml"
    yaml_path.write_text(
        "TRAIN:\n  BATCH_SIZE: 4\n  EVAL_PERIOD: 1\n  CHECKPOINT_PERIOD: 1\n"
        f"DATA:\n  PATH_PREFIX: '{prefix}'\n  PATH_TO_DATA_DIR: '{splits}'\n"
        "  DECODING_BACKEND: npy\n  GAUSSIAN_KERNEL: 5\n"
        "  TRAIN_CROP_SIZE: 32\n  TEST_CROP_SIZE: 32\n  TRAIN_JITTER_SCALES: [32, 32]\n"
        "  AUDIO_FREQ_BINS: 32\n  AUDIO_WINDOW: 32\n"
        "MVIT:\n  DEPTH: 6\n  EMBED_DIM: 16\n  DROPPATH_RATE: 0.1\n  CLS_EMBED_ON: False\n"
        "  SEP_POS_EMBED: True\n  PATCH_PADDING: [1, 3, 3]\n  POOL_KVQ_KERNEL: [3, 3, 3]\n"
        "  POOL_KV_STRIDE_ADAPTIVE: [1, 8, 8]\n"
        "  DIM_MUL: [[1, 2.0], [2, 2.0], [3, 2.0]]\n  HEAD_MUL: [[1, 2.0], [2, 2.0], [3, 2.0]]\n"
        "  POOL_Q_STRIDE: [[1, 1, 2, 2], [2, 1, 2, 2], [3, 1, 2, 2]]\n"
        "SOLVER:\n  MAX_EPOCH: 1\n  BASE_LR: 1e-4\n  EMA_DECAY: 0.9\n"
        "MODEL:\n  LOSS_FUNC: kldiv+egonce\n"
        "TEST:\n  BATCH_SIZE: 4\n  NUM_ENSEMBLE_VIEWS: 1\n  NUM_SPATIAL_CROPS: 1\n"
        "DATA_LOADER:\n  NUM_WORKERS: 0\nLOG_PERIOD: 1\n")
    npz = {}
    for tag, extra in (("one", []), (axis, ["NUM_DEVICES", "2", f"PARALLEL.{axis.upper()}", "2"])):
        out = str(tmp_path / tag)
        run_net.main(["--device", "cpu", "--cfg", str(yaml_path), "OUTPUT_DIR", out] + extra)
        npz[tag] = np.load(os.path.join(tcu.checkpoint_dir(out), "checkpoint_epoch_00001.npz"))
    a, b = npz["one"], npz[axis]
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_allclose(b[k], a[k], atol=2 * 2 * 1e-4, rtol=0, err_msg=k)

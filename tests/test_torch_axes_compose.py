"""The parallel axes composed (``csts_torch/parallel/mesh.py``,
``parallel/pipeline.py``, ``train/optimizer.py``, ``utils/checkpoint.py``)
on four gloo ranks on the CPU, against one process and against the JAX
package, which runs its trainer under any mesh
(``csts_tpu/parallel/mesh.py`` ``fsdp_param_sharding`` and
``zero1_opt_sharding`` over the data axis, the pipelined run under
``seq_constraint``, ``csts_tpu/models/csts.py:535-538``).

One group of four ranks, spawned once for the module, runs five layouts in
turn at ``small_cfg`` with 6 video blocks and drop-path 0.2 (v4-v5 the
pipelined run): sp2 x pp2; dp2 x pp2 and dp2 x sp2 under SOLVER.FSDP;
dp2 x tp2 and dp2 x pp2 under SOLVER.ZERO1. For each:

* the fp32 eval logits of each rank's stripe within 5e-4 of JAX's
  one-device ``csts_apply`` and within 2e-5 of the port's one process;
* one training step at ``tests/test_torch_parallel.py``'s whole-step bars;
* what each rank holds after it: under FSDP every parameter a DTensor
  shard, under ZeRO-1 the moments of its data rank's share only (and under
  tp2 the split leaves still split);
* rank 0's npz TrainState loaded into one process: its params and moments
  equal to one process's after the same step, at the step's bars.

Also: ``mesh.sync_grads`` sums the seq axis's parts before the pipe axis's
(the other order leaves a stage's rank its own stripe's part of the other
stage's blocks). ``-m slow``: ``run_net`` training and testing under
sp2 x pp2 and under dp2 x pp2 with FSDP (four ranks spawned by ``run_net``),
and one step of pp2 x sp2 x tp2 on eight ranks.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from csts_torch.train import step as tstep
from csts_torch.utils import checkpoint as tcu
from csts_tpu.models import csts as jcsts
from test_torch_model_axes import _inputs, _one_process
from test_torch_multiproc import run_ranks
from test_torch_parallel import _assert_grads, _assert_params
from torch_axes_workers import LAYOUTS, compose_worker, sync_order_worker, whole_params

torch.set_num_threads(2)

NAMES = list(LAYOUTS)
FSDP = [n for n in NAMES if LAYOUTS[n][1].get("FSDP")]
ZERO1 = [n for n in NAMES if LAYOUTS[n][1].get("ZERO1")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's one-device eval forward, the port's one process, and the four
    ranks under each layout, from one init, batch and masks."""
    out = str(tmp_path_factory.mktemp("compose"))
    jspec, params, batch, cfg, spec, sd, tbatch, drop = _inputs(out)
    jlogits = jax.jit(lambda p, v, a: jcsts.csts_apply(p, jspec, v, a, deterministic=True))(
        params, jnp.asarray(batch["video"]), jnp.asarray(batch["audio"]))
    run_ranks(compose_worker, os.path.join(out, "inputs.pt"), out, NAMES, world=4,
              timeout=400)
    ranks = [torch.load(os.path.join(out, f"compose{r}.pt")) for r in range(4)]
    return {"jax": np.asarray(jlogits), "one": _one_process(cfg, spec, sd, tbatch, drop),
            "got": {n: [rk[n] for rk in ranks] for n in NAMES}, "cfg": cfg, "spec": spec,
            "sd": sd}


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax_and_one_process(runs, name):
    """Each rank's stripe of the batch (the whole batch without a data
    axis) within 5e-4 of JAX and 2e-5 of one process; the rows are the
    rank's data coordinate's."""
    for res in runs["got"][name]:
        lo, n = res["rows"]
        data = 1 if "dp2" not in name else 2
        assert (lo, n) == (res["coords"]["data"] * 4 // data, 4 // data), (name, res["rows"])
        got = res["logits"].numpy()
        np.testing.assert_allclose(got, runs["jax"][lo:lo + n], atol=5e-4, rtol=0)
        np.testing.assert_allclose(got, runs["one"]["logits"][lo:lo + n].numpy(), atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_step_matches_one_process(runs, name):
    """The global batch's losses and the pre-clip norm within 1e-5
    relative; every rank's gradients and updated params at the whole-step
    bars; each axis of the layout ran its collectives."""
    want = runs["one"]
    axes = LAYOUTS[name][0]
    for res in runs["got"][name]:
        for k in ("loss", "kldiv_loss", "egonce_loss", "grad_norm"):
            assert res["stats"][k] == pytest.approx(want["stats"][k], rel=1e-5), k
        _assert_grads(res["grads"], want["grads"])
        _assert_params(res["params"], want["params"], 1e-6, want["grads"],
                       runs["cfg"].SOLVER.BASE_LR)
        for axis in axes:
            assert res["counts"].get(axis, 0) > 0, (name, axis, res["counts"])
        if "pipe" in axes:
            assert res["pipe_plan"] == {"S": 2, "M": 2}


@pytest.mark.parametrize("name", FSDP)
def test_fsdp_keeps_the_parameters_sharded(runs, name):
    """Under FSDP every parameter is still a DTensor after the step, the
    blocks of the pipelined run and of the other stage included, and each
    rank holds about half of the model (its data rank's shard)."""
    for res in runs["got"][name]:
        assert res["all_dtensor"], name
        assert 0.45 < res["held"] < 0.55, (name, res["held"])
        assert len(res["moments_of"]) == len(runs["sd"]), name


@pytest.mark.parametrize("name", ZERO1)
def test_zero1_keeps_the_moments_sharded(runs, name):
    """Under ZeRO-1 each rank keeps the moments of its data rank's share:
    the two data ranks of one place on the other axes hold disjoint shares
    that cover every parameter; under tp2 the Megatron leaves and the
    moments of them a rank keeps are still split."""
    got = runs["got"][name]
    every = set(runs["sd"])
    for res in got:
        partner = next(o for o in got if o["coords"]["data"] != res["coords"]["data"]
                       and all(o["coords"][a] == res["coords"][a]
                               for a in ("pipe", "seq", "model")))
        mine, theirs = set(res["moments_of"]), set(partner["moments_of"])
        assert mine and theirs and not mine & theirs and mine | theirs == every, name
        assert res["held"] == 1.0 and not res["all_dtensor"]
        if "tp2" in name:
            assert len(res["split"]) >= 6 * 10
            for how, shape, mu, nu in res["split"].values():
                assert mu in (None, shape) and nu == mu
            assert any(s[2] is not None for s in res["split"].values())


def _moment_bars(want_grads: dict) -> tuple:
    """After one Adam step the first moment is 0.1·g and the second
    0.001·g²: each gradient's bar (``_assert_grads``) carried through."""
    floor = 1e-8 * max(float(w.abs().max()) for w in want_grads.values())
    first, second = {}, {}
    for n, w in want_grads.items():
        gbar = 1e-5 * float(w.abs().max()) + floor
        first[n] = 0.1 * gbar
        second[n] = 0.001 * gbar * (2 * float(w.abs().max()) + gbar)
    return first, second


@pytest.mark.parametrize("name", NAMES)
def test_saved_train_state_loads_into_one_process(runs, name):
    """Rank 0's npz TrainState (every parameter and moment gathered whole)
    loads into a one-process state, whose params, moments, count, step and
    learning rate are one process's after the same step, at the step's
    bars."""
    path = runs["got"][name][0]["npz"]
    assert all(r["npz"] == path for r in runs["got"][name])
    cfg, spec, want = runs["cfg"], runs["spec"], runs["one"]
    state = tstep.create_train_state(cfg, spec, state_dict=runs["sd"], device="cpu")
    tcu.load_checkpoint(path, state)
    assert state.step == want["step"] == 1
    assert state.optimizer.lr == pytest.approx(want["lr"], rel=1e-7)  # an fp32 leaf
    _assert_params(whole_params(state.model), want["params"], 1e-6, want["grads"],
                   cfg.SOLVER.BASE_LR)
    count, first, second = state.optimizer.moments()
    wcount, wfirst, wsecond = want["moments"]
    assert count == wcount == 1
    bar1, bar2 = _moment_bars(want["grads"])
    for n in wfirst:
        assert float((first[n] - wfirst[n]).abs().max()) <= bar1[n], n
        assert float((second[n] - wsecond[n]).abs().max()) <= bar2[n], n


def test_sync_grads_sums_seq_before_pipe(tmp_path):
    """sp2 x pp2: each rank holds its stripe's part of its own stage's block
    gradient. ``sync_grads`` (seq, then pipe) gives every rank both
    stages' whole gradients; the pipe sum first leaves each rank its own
    stripe's part of the other stage's block."""
    run_ranks(sync_order_worker, str(tmp_path), world=4, timeout=120)
    for r in range(4):
        res = torch.load(tmp_path / f"sync{r}.pt")
        s = res["stage"]
        assert [float(g[0]) for g in res["seq_then_pipe"]] == [1 + 2, 11 + 12]
        wrong = [float(g[0]) for g in res["pipe_then_seq"]]
        assert wrong[s] == [3, 23][s] and wrong[1 - s] != [3, 23][1 - s], (r, wrong)


def _run_net_yaml(tmp_path):
    from csts_torch.data.synthetic import write_dataset

    prefix, splits = write_dataset(str(tmp_path / "data"), "ego4d", num_clips=8, res=(32, 48),
                                   seed=5)
    path = tmp_path / "cfg.yaml"
    path.write_text(
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
    return path


@pytest.mark.slow
@pytest.mark.parametrize("layout", ["sp2xpp2", "dp2xpp2_fsdp"])
def test_run_net_trains_and_tests_under_composed_axes(tmp_path, layout):
    """``run_net --device cpu NUM_DEVICES 4`` with the layout's PARALLEL.*
    and SOLVER.* keys (four ranks spawned by run_net, meeting through its
    store file; the mesh installed by ``init_from_cfg``) trains an epoch of
    two iterations at global batch 4 and tests its npz: the npz within
    2·Σlr of one process's run, leaf by leaf, and rank 0's logged test
    metrics within 1e-5 of one process's."""
    from csts_torch.tools import run_net

    yaml_path = _run_net_yaml(tmp_path)
    axes, solver = LAYOUTS[layout]
    extra = ["NUM_DEVICES", "4"]
    for a, n in axes.items():
        extra += [f"PARALLEL.{a.upper()}", str(n)]
    for k, v in solver.items():
        extra += [f"SOLVER.{k}", str(v)]
    npz, stats = {}, {}
    for tag, opts in (("one", []), (layout, extra)):
        out = str(tmp_path / tag)
        stats[tag] = run_net.main(["--device", "cpu", "--cfg", str(yaml_path), "OUTPUT_DIR", out]
                                  + opts)
        npz[tag] = np.load(os.path.join(tcu.checkpoint_dir(out), "checkpoint_epoch_00001.npz"))
    a, b = npz["one"], npz[layout]
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_allclose(b[k], a[k], atol=2 * 2 * 1e-4, rtol=0, err_msg=k)
    assert stats[layout] == {}  # the spawning parent returns no stats
    with open(tmp_path / layout / "stdout.log") as f:
        final = [json.loads(line.split("json_stats: ", 1)[1]) for line in f
                 if '"_type": "test_final"' in line]
    assert len(final) == 1
    for k in ("f1", "recall", "precision", "threshold", "auc"):
        assert final[0][k] == pytest.approx(stats["one"][k], abs=1e-5), k


@pytest.mark.slow
def test_eight_ranks_pipe_seq_model(tmp_path):
    """pp2 x sp2 x tp2 on eight ranks: one step against one process at the
    whole-step bars, the forward within 2e-5, collectives on every axis."""
    _, _, _, cfg, spec, sd, tbatch, drop = _inputs(str(tmp_path))
    want = _one_process(cfg, spec, sd, tbatch, drop)
    layout = ({"pipe": 2, "seq": 2, "model": 2}, {})
    run_ranks(compose_worker, str(tmp_path / "inputs.pt"), str(tmp_path), [layout], world=8,
              timeout=600)
    for r in range(8):
        res = torch.load(tmp_path / f"compose{r}.pt")["pipe2xseq2xmodel2"]
        np.testing.assert_allclose(res["logits"].numpy(), want["logits"].numpy(), atol=2e-5)
        for k in ("loss", "grad_norm"):
            assert res["stats"][k] == pytest.approx(want["stats"][k], rel=1e-5), k
        _assert_grads(res["grads"], want["grads"])
        _assert_params(res["params"], want["params"], 1e-6, want["grads"], cfg.SOLVER.BASE_LR)
        assert all(res["counts"].get(a, 0) > 0 for a in ("pipe", "seq", "model")), res["counts"]


def test_touched_modules_reach_the_isolation_walk():
    """The modules this composition runs through are in the package walk
    that ``tests/test_torch_isolation.py`` imports in a fresh interpreter
    and parses for forbidden imports; so is ``chip_smoke.py``."""
    import pkgutil

    import csts_torch
    from test_torch_isolation import PORT_FILES

    mods = {m.name for m in pkgutil.walk_packages(csts_torch.__path__, "csts_torch.")}
    assert {"csts_torch.parallel.mesh", "csts_torch.parallel.pipeline",
            "csts_torch.parallel.collectives", "csts_torch.models.csts",
            "csts_torch.train.optimizer", "csts_torch.train.step", "csts_torch.utils.checkpoint",
            "csts_torch.tools.run_net"} <= mods
    assert any(f.endswith("chip_smoke.py") for f in PORT_FILES)

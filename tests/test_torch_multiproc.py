"""Several processes on the CPU: groups of two gloo ranks (``torch.distributed``)
against one process, through the port's own entry points.

* The collectives: ``gather_objects`` of unequal pickles, ``any_rank``, and
  ``all_gather_with_grad``'s gradient under DDP's sum over ranks against
  one process's gradient of the same objective.
* ``train()`` on two ranks with SIGTERM sent to one rank only: both stop
  at the same iteration (the MAX all-reduce of the stop flag), rank 0 saves
  the iter-tagged npz, and the resumed run ends bit-equal to an
  uninterrupted two-rank run; the two-rank npz loads into one process and
  saves back bit for bit, and a one-process npz into two ranks.
* ``train()`` on two ranks under SOLVER.FSDP with a val split that leaves
  rank 1's stripe of the last batch empty: the run ends (the empty rank
  joins each forward's parameter gather) with one process's records.
* ``tester.test`` on two ranks against one process at one and two views
  (metrics within 1e-6, the results npz equal, every row scored once), with
  a rank whose stripe of the last batch is empty (it runs no forward for it)
  and clips whose two views straddle the ranks' stripes.
* ``run_net --num-shards 2 --device cpu``: two OS processes train, then test.

Each group meets through its own store file with a 60 s collective timeout, and
``run_ranks`` kills its ranks after its own limit, so nothing can hang the
lane. The workers live in this module, which imports no JAX, so the spawned
ranks start fast; ``tests/test_torch_parallel.py`` uses them against JAX.
"""

from __future__ import annotations

import datetime
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from csts_torch import presets
from csts_torch.data.synthetic import write_dataset
from csts_torch.eval import tester
from csts_torch.models.csts import build_spec
from csts_torch.parallel import collectives, mesh
from csts_torch.train import step as tstep
from csts_torch.train import trainer as ttrainer
from csts_torch.utils import checkpoint as tcu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2

torch.set_num_threads(2)


# ----------------------------------------------------------------------------------
# the harness
# ----------------------------------------------------------------------------------


def _rank(rank: int, fn, world: int, init: str, args) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, *args, world: int = WORLD, timeout: float = 240.0) -> None:
    """``fn(rank, *args)`` in ``world`` spawned processes joined in one gloo
    group; raises what a rank raised, and kills the ranks past ``timeout``
    seconds. ``fn`` is a module-level function; results go through files.
    The ranks meet through a store file of their own (``mesh.rendezvous``),
    never a port that another group could take."""
    with mesh.rendezvous() as init:
        ctx = torch.multiprocessing.start_processes(
            _rank, args=(fn, world, init, args), nprocs=world, join=False,
            start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=2):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{fn.__name__} ran past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)


def stripe(batch: dict, rank: int, world: int = WORLD) -> dict:
    """Rank ``rank``'s rows of a global batch of tensors."""
    n = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


# ----------------------------------------------------------------------------------
# the collectives
# ----------------------------------------------------------------------------------


def _objective(y: torch.Tensor, rank: int) -> torch.Tensor:
    """A loss that mixes the rows (as EgoNCE does), weighted per rank."""
    return (rank + 1) * torch.logsumexp(y @ y.t(), dim=1).sum()


def _rows(rank: int) -> torch.Tensor:
    return torch.randn(3, 5, generator=torch.Generator().manual_seed(10 + rank)) * 0.3


def collectives_worker(rank: int, out: str) -> None:
    import logging

    from csts_torch.utils.logging import setup_logging

    x = _rows(rank).requires_grad_()
    y = collectives.all_gather_with_grad(x)
    _objective(y, rank).backward()
    setup_logging(None)
    res = {
        "grad": x.grad,
        "gathered": y.detach(),
        "objects": collectives.gather_objects({"rank": rank, "pad": "x" * (100 * rank + 7)}),
        "any_one": collectives.any_rank(rank == 1),
        "any_none": collectives.any_rank(False),
        "sum": collectives.all_reduce_sum(torch.tensor([1.0, rank])),
        "null_log": [type(h).__name__ for h in logging.getLogger().handlers],
        "master": collectives.is_master_proc(),
    }
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def test_collectives_on_two_ranks(tmp_path):
    """The gradient of each rank's rows is the sum over the ranks' objectives
    (what DDP's mean then divides by W), equal to one process's gradient of
    the summed objective at the whole batch; rank 1's rows are not rank 0's
    slice."""
    run_ranks(collectives_worker, str(tmp_path), timeout=120)
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    full = torch.cat([_rows(r) for r in range(WORLD)]).requires_grad_()
    sum(_objective(full, r) for r in range(WORLD)).backward()
    for r in range(WORLD):
        torch.testing.assert_close(res[r]["gathered"], full.detach(), rtol=0, atol=0)
        torch.testing.assert_close(res[r]["grad"], full.grad[3 * r:3 * (r + 1)],
                                   rtol=1e-6, atol=1e-6)
        assert [o["rank"] for o in res[r]["objects"]] == [0, 1]
        assert [len(o["pad"]) for o in res[r]["objects"]] == [7, 107]
        assert res[r]["any_one"] is True and res[r]["any_none"] is False
        assert res[r]["sum"].tolist() == [2.0, 1.0]
    assert not torch.allclose(full.grad[3:], full.grad[:3])
    assert res[0]["master"] and not res[1]["master"]
    # rank 0 logs to stdout, the other rank's root logger has only a null handler
    assert "StreamHandler" in res[0]["null_log"] and res[1]["null_log"] == ["NullHandler"]


# ----------------------------------------------------------------------------------
# the trainer on two ranks: the stop flag, resume, npz across sharding
# ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_split(tmp_path_factory):
    """Eight clips of 32x48 (crops without a resize): two global batches of
    four an epoch."""
    root = str(tmp_path_factory.mktemp("mp_train"))
    return write_dataset(root, "ego4d", num_clips=8, res=(32, 48), seed=5)


def train_cfg(split, out: str, batch: int = 4):
    prefix, splits = split
    cfg = presets.small_cfg(batch)
    cfg.DATA.PATH_PREFIX, cfg.DATA.PATH_TO_DATA_DIR = prefix, splits
    cfg.DATA.DECODING_BACKEND = "npy"
    cfg.DATA.GAUSSIAN_KERNEL = 5
    cfg.DATA.TRAIN_JITTER_SCALES = [32, 32]
    cfg.MVIT.DROPPATH_RATE = 0.2
    cfg.SOLVER.EMA_DECAY = 0.9
    cfg.SOLVER.MAX_EPOCH = 2
    cfg.TRAIN.EVAL_PERIOD = cfg.TRAIN.CHECKPOINT_PERIOD = 1
    cfg.DATA_LOADER.NUM_WORKERS = 0
    cfg.LOG_PERIOD = 1
    cfg.TEST.ENABLE = False
    cfg.OUTPUT_DIR = out
    return cfg


def trainer_worker(rank: int, split, out: str) -> None:
    """An uninterrupted run; a run whose rank 1 alone receives SIGTERM after
    its first step; that run resumed; then the one-process npz of the
    parent loaded here and saved back by rank 0."""
    ttrainer.train(train_cfg(split, os.path.join(out, "whole")), device="cpu")
    signalled = []
    make = tstep.make_train_step

    def make_signalling(*a, **k):
        fn = make(*a, **k)

        def run(state, batch, gen, drop=None):
            res = fn(state, batch, gen, drop)
            if rank == 1 and state.step == 1:
                signalled.append(state.step)
                os.kill(os.getpid(), signal.SIGTERM)
            return res
        return run

    tstep.make_train_step = make_signalling
    try:
        state = ttrainer.train(train_cfg(split, os.path.join(out, "cut")), device="cpu")
    finally:
        tstep.make_train_step = make
    stopped = state.step
    ttrainer.train(train_cfg(split, os.path.join(out, "cut")), device="cpu")
    # the parent's one-process npz on two ranks, saved back by rank 0
    cfg = train_cfg(split, os.path.join(out, "reload"))
    state = tstep.create_train_state(cfg, build_spec(cfg), device="cpu")
    tcu.load_checkpoint(os.path.join(out, "one.npz"), state)
    tcu.save_checkpoint(cfg.OUTPUT_DIR, state, 0, cfg)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"signalled": signalled, "stopped_at_step": stopped}, f)


def _log(out_dir: str, kind: str) -> list:
    with open(os.path.join(out_dir, "stdout.log")) as f:
        return [r for r in (json.loads(line.split("json_stats: ", 1)[1]) for line in f
                            if "json_stats: " in line) if r["_type"] == kind]


def _leaves(path: str) -> dict:
    with np.load(path) as blob:
        return {k: blob[k] for k in blob.files}


def _assert_equal_npz(a: str, b: str) -> None:
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def test_trainer_stop_flag_resume_and_npz_across_ranks(train_split, tmp_path):
    """SIGTERM reaches rank 1 only, after its first step: both ranks stop
    after that step (neither waits in a collective), rank 0 writes
    ``..._iter_0000001.npz``, and the resumed run's final npz equals the
    uninterrupted two-rank run's bit for bit, and whose records (logged by
    rank 0 alone) are the global batch's, as one process at batch 4 logs
    them. The two-rank npz (3P+4+P leaves with the EMA) loads into one
    process, which saves it back bit for bit, and one process's npz loads
    into two ranks, rank 0 saving it back bit for bit."""
    out = str(tmp_path)
    one_cfg = train_cfg(train_split, os.path.join(out, "one_run"))
    one = tstep.create_train_state(one_cfg, build_spec(one_cfg), device="cpu")
    tstep.make_train_step(one_cfg, build_spec(one_cfg), 2)(
        one, _random_batch(4, one_cfg), torch.Generator().manual_seed(3))
    saved = tcu.save_checkpoint(one_cfg.OUTPUT_DIR, one, 0, one_cfg)
    for suffix in ("", ".json"):
        os.replace(saved + suffix, os.path.join(out, "one.npz" + suffix))

    run_ranks(trainer_worker, train_split, out, timeout=300)
    info = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(WORLD)]
    assert info[0]["signalled"] == [] and info[1]["signalled"] == [1]
    assert info[0]["stopped_at_step"] == info[1]["stopped_at_step"] == 1
    cut_dir = tcu.checkpoint_dir(os.path.join(out, "cut"))
    assert "checkpoint_epoch_00000_iter_0000001.npz" in os.listdir(cut_dir)
    whole = tcu.get_last_checkpoint(os.path.join(out, "whole"))
    assert whole.endswith("checkpoint_epoch_00002.npz")
    _assert_equal_npz(tcu.get_last_checkpoint(os.path.join(out, "cut")), whole)

    # rank 0's records are the global batch's: one process at batch 4 logs
    # the same losses (1e-5 relative: the weights differ by fp32 sums' order)
    # and F1s (5e-3: a threshold of 31 over 64 pixels a frame may flip a pixel)
    one_run = ttrainer.train(train_cfg(train_split, os.path.join(out, "one_whole")), device="cpu")
    assert one_run.step == 4
    for kind, keys in (("train_iter", ("loss", "f1", "lr")), ("val_epoch", ("f1", "recall"))):
        got, want = _log(os.path.join(out, "whole"), kind), _log(os.path.join(out, "one_whole"),
                                                                  kind)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for k in keys:
                tol = 1e-5 * abs(w[k]) if k in ("loss", "lr") else 5e-3
                assert abs(g[k] - w[k]) <= tol + 1e-5, (kind, k, g[k], w[k])

    # the two-rank npz on one process, saved back
    cfg = train_cfg(train_split, os.path.join(out, "single"))
    state = tstep.create_train_state(cfg, build_spec(cfg), device="cpu")
    assert tcu.load_checkpoint(whole, state) == 1
    _assert_equal_npz(tcu.save_checkpoint(cfg.OUTPUT_DIR, state, 1, cfg), whole)
    _assert_equal_npz(tcu.get_last_checkpoint(os.path.join(out, "reload")),
                      os.path.join(out, "one.npz"))


def one_epoch_cfg(split, out: str, fsdp: bool = False):
    cfg = train_cfg(split, out)
    cfg.SOLVER.FSDP = fsdp
    cfg.SOLVER.MAX_EPOCH = 1
    return cfg


def fsdp_val_worker(rank: int, split, out: str) -> None:
    ttrainer.train(one_epoch_cfg(split, out, fsdp=True), device="cpu")


def test_trainer_fsdp_validates_with_an_empty_stripe(tmp_path):
    """Five clips at batch 4 (2 a rank): the val split's last global batch
    holds one row, so rank 1's stripe of it is empty. Under SOLVER.FSDP each
    forward gathers the parameters on every rank, so rank 1 still takes part
    (one placeholder row, scored nowhere) and the run ends, rank 0's records
    equal to one process's at batch 4 (losses within 1e-5 relative, F1s
    within 5e-3, as above)."""
    split = write_dataset(str(tmp_path / "data"), "ego4d", num_clips=5, res=(32, 48), seed=6)
    run_ranks(fsdp_val_worker, split, str(tmp_path / "fsdp"), timeout=200)
    ttrainer.train(one_epoch_cfg(split, str(tmp_path / "one")), device="cpu")
    for kind, keys in (("train_iter", ("loss", "f1")), ("val_iter", ("f1", "recall")),
                       ("val_epoch", ("f1", "recall"))):
        got, want = _log(str(tmp_path / "fsdp"), kind), _log(str(tmp_path / "one"), kind)
        assert len(got) == len(want) > 0, kind
        for g, w in zip(got, want):
            for k in keys:
                tol = 1e-5 * abs(w[k]) if k == "loss" else 5e-3
                assert abs(g[k] - w[k]) <= tol + 1e-5, (kind, k, g[k], w[k])


def _random_batch(n: int, cfg) -> dict:
    rng = np.random.default_rng(8)
    hm = rng.uniform(0.0, 1.0, (n, 8, 8, 8)).astype(np.float32)
    crop = cfg.DATA.TRAIN_CROP_SIZE
    return {
        "video": torch.from_numpy(rng.standard_normal((n, 8, crop, crop, 3)).astype(np.float32)),
        "audio": torch.from_numpy(rng.standard_normal((n, 8, 32, 32, 1)).astype(np.float32)),
        "labels_hm": torch.from_numpy(hm / hm.sum(axis=(2, 3), keepdims=True)),
    }


# ----------------------------------------------------------------------------------
# the tester on two ranks
# ----------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def eval_split(tmp_path_factory):
    """Seven clips and seeded weights: at TEST.BATCH_SIZE 6 (3 a rank) the
    last global batch of one view holds one row, so rank 1's stripe of it is
    empty; at two views rows 2-3 and 8-9 (one clip each) straddle the
    ranks' stripes."""
    root = str(tmp_path_factory.mktemp("mp_test"))
    prefix, splits = write_dataset(root, "ego4d", num_clips=7, res=(32, 48), seed=12)
    cfg = presets.small_cfg(6)
    state = tstep.create_train_state(cfg, build_spec(cfg), torch.Generator().manual_seed(4),
                                     device="cpu")
    path = os.path.join(root, "weights.pyth")
    torch.save({"model_state": state.model.state_dict()}, path)
    return prefix, splits, path


def eval_cfg(split, out: str, views: int):
    prefix, splits, path = split
    cfg = presets.small_cfg(6)
    cfg.DATA.PATH_PREFIX, cfg.DATA.PATH_TO_DATA_DIR = prefix, splits
    cfg.DATA.DECODING_BACKEND = "npy"
    cfg.DATA.GAUSSIAN_KERNEL = 5
    cfg.TRAIN.ENABLE = False
    cfg.TEST.DATASET = "ego4d_av_gaze_forecast" if views == 1 else "ego4d_av_gaze"
    cfg.TEST.BATCH_SIZE = 6
    cfg.TEST.NUM_ENSEMBLE_VIEWS = views
    cfg.TEST.NUM_SPATIAL_CROPS = 1
    cfg.TEST.CHECKPOINT_FILE_PATH = path
    cfg.TEST.SAVE_RESULTS_PATH = "results"
    cfg.DATA_LOADER.NUM_WORKERS = 0
    cfg.OUTPUT_DIR = out
    cfg.LOG_PERIOD = 1
    return cfg


def eval_worker(rank: int, split, out: str) -> None:
    from csts_torch.train import step as step_lib

    calls = []
    make = step_lib.make_eval_step

    def counting(*a, **k):
        fn = make(*a, **k)

        def run(model, batch):
            calls.append(int(batch["video"].shape[0]))
            return fn(model, batch)
        return run

    step_lib.make_eval_step = counting
    res = {}
    try:
        for views in (1, 2):
            calls.clear()
            stats = tester.test(eval_cfg(split, os.path.join(out, f"v{views}"), views), "cpu")
            res[views] = {"stats": {k: stats[k] for k in METRICS}, "rows": list(calls)}
    finally:
        step_lib.make_eval_step = make
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


METRICS = ("f1", "recall", "precision", "threshold", "auc")


def test_tester_two_ranks_match_one_process(eval_split, tmp_path):
    """Both ranks return the whole split's metrics, within 1e-6 of one
    process's (the threshold equal), at one and two views; rank 0's results
    npz equals one process's, every row once. At one view rank 1 runs two
    forwards for the three global batches (its stripe of the last is
    empty); at two views the straddling clips are scored on both views."""
    run_ranks(eval_worker, eval_split, str(tmp_path), timeout=240)
    got = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(WORLD)]
    for views in (1, 2):
        want = tester.test(eval_cfg(eval_split, str(tmp_path / f"one{views}"), views), "cpu")
        for r in range(WORLD):
            stats = got[r][str(views)]["stats"]
            assert stats["threshold"] == want["threshold"]
            for k in METRICS:
                assert abs(stats[k] - want[k]) <= 1e-6, (views, r, k, stats[k], want[k])
        a = np.load(tmp_path / f"v{views}" / "results.npz")
        b = np.load(tmp_path / f"one{views}" / "results.npz")
        np.testing.assert_array_equal(a["index"], np.arange(7 * views))
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got[0]["1"]["rows"] == [3, 1] and got[1]["1"]["rows"] == [3]
    assert got[0]["2"]["rows"] == [3, 3, 2] and got[1]["2"]["rows"] == [3, 3]


# ----------------------------------------------------------------------------------
# run_net across two shards, one OS process each
# ----------------------------------------------------------------------------------


def test_run_net_two_shards_on_the_cpu(train_split, tmp_path):
    """``run_net --num-shards 2 --device cpu``: shard 0 and shard 1 as two
    OS processes meeting at one ``--init-method``; they train an epoch
    (global batch 4, 2 a rank) and test its npz. Rank 0 alone writes the
    npz and the log, whose records carry the global batch."""
    prefix, splits = train_split
    yaml_path = tmp_path / "cfg.yaml"
    yaml_path.write_text(
        "TRAIN:\n  BATCH_SIZE: 4\n  EVAL_PERIOD: 1\n  CHECKPOINT_PERIOD: 1\n"
        f"DATA:\n  PATH_PREFIX: '{prefix}'\n  PATH_TO_DATA_DIR: '{splits}'\n"
        "  DECODING_BACKEND: npy\n  GAUSSIAN_KERNEL: 5\n"
        "  TRAIN_CROP_SIZE: 32\n  TEST_CROP_SIZE: 32\n  TRAIN_JITTER_SCALES: [32, 32]\n"
        "  AUDIO_FREQ_BINS: 32\n  AUDIO_WINDOW: 32\n"
        "MVIT:\n  DEPTH: 4\n  EMBED_DIM: 16\n  DROPPATH_RATE: 0.1\n  CLS_EMBED_ON: False\n"
        "  SEP_POS_EMBED: True\n  PATCH_PADDING: [1, 3, 3]\n  POOL_KVQ_KERNEL: [3, 3, 3]\n"
        "  POOL_KV_STRIDE_ADAPTIVE: [1, 8, 8]\n"
        "  DIM_MUL: [[1, 2.0], [2, 2.0], [3, 2.0]]\n  HEAD_MUL: [[1, 2.0], [2, 2.0], [3, 2.0]]\n"
        "  POOL_Q_STRIDE: [[1, 1, 2, 2], [2, 1, 2, 2], [3, 1, 2, 2]]\n"
        "SOLVER:\n  MAX_EPOCH: 1\n  BASE_LR: 1e-4\n  BASE_LR_SCALE_NUM_SHARDS: True\n"
        "MODEL:\n  LOSS_FUNC: kldiv+egonce\n"
        "TEST:\n  BATCH_SIZE: 4\n  NUM_ENSEMBLE_VIEWS: 1\n  NUM_SPATIAL_CROPS: 1\n"
        "DATA_LOADER:\n  NUM_WORKERS: 0\nLOG_PERIOD: 1\n")
    out = str(tmp_path / "run")
    init = f"file://{tmp_path / 'store'}"  # a store file of this test's own
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "csts_torch.tools.run_net", "--device", "cpu", "--cfg",
         str(yaml_path), "--num-shards", "2", "--shard-id", str(s), "--init-method", init,
         "OUTPUT_DIR", out], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for s in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert sorted(n for n in os.listdir(tcu.checkpoint_dir(out)) if n.endswith(".npz")) == [
        "checkpoint_epoch_00001.npz"]
    with open(os.path.join(out, "stdout.log")) as f:
        records = [json.loads(line.split("json_stats: ", 1)[1]) for line in f
                   if "json_stats: " in line]
    kinds = [r["_type"] for r in records]
    assert kinds.count("train_iter") == 2 and "val_epoch" in kinds and kinds[-1] == "test_final"
    # BASE_LR_SCALE_NUM_SHARDS: the LRs scaled by the two shards
    meta = tcu.checkpoint_meta(os.path.join(tcu.checkpoint_dir(out), "checkpoint_epoch_00001.npz"))
    assert meta["cfg"]["SOLVER"]["BASE_LR"] == pytest.approx(2e-4)
    assert "json_stats" not in logs[1]  # rank 1 logs nothing


# ----------------------------------------------------------------------------------
# the train step on two ranks (held against one process and JAX in
# tests/test_torch_parallel.py)
# ----------------------------------------------------------------------------------

MODES = {"ddp": {}, "accum": {}, "zero1": {"ZERO1": True}, "fsdp": {"FSDP": True}}


def step_cfg(mode: str = "ddp"):
    """``small_cfg`` at global batch 4: drop-path 0.2, kldiv+egonce, EMA."""
    cfg = presets.small_cfg(4)
    cfg.MVIT.DROPPATH_RATE = 0.2
    cfg.SOLVER.EMA_DECAY = 0.9
    for k, v in MODES[mode].items():
        setattr(cfg.SOLVER, k, v)
    return cfg


def step_masks(drop: list, accum: int) -> list:
    """A global batch's masks as ``train_step`` takes them at ``accum``
    micro-batches: one set a micro-batch of the global batch."""
    if accum == 1:
        return drop
    n = next(m for m in drop if m is not None)[0].shape[0] // accum
    return [[None if m is None else tuple(x[i * n:(i + 1) * n] for x in m) for m in drop]
            for i in range(accum)]


def run_steps(state, cfg, batch: dict, drops: list, accum: int = 1) -> dict:
    """Two steps with the given global masks: the stats, every gradient
    after step 1 (whole), the params after step 2 (whole)."""
    step = tstep.make_train_step(cfg, build_spec(cfg), steps_per_epoch=10, accum_steps=accum)
    out = {"stats": []}
    for i, drop in enumerate(drops):
        stats, _ = step(state, batch, None, drop=step_masks(drop, accum))
        out["stats"].append({k: float(v) for k, v in stats.items()})
        if i == 0:
            out["grads"] = {n: collectives.whole(p.grad).detach().clone()
                            for n, p in state.model.named_parameters()}
    out["params"] = {n: collectives.whole(p.detach()).cpu().clone()
                     for n, p in state.model.named_parameters()}
    out["grads"] = {n: g.cpu() for n, g in out["grads"].items()}
    return out


def _to(drop: list, device) -> list:
    return [None if m is None else tuple(x.to(device) for x in m) for m in drop]


def step_worker(rank: int, inputs: str, out: str, modes, device: str = "cpu") -> None:
    """Each mode from the same weights, batch and masks: two steps on this
    rank's stripe, the npz rank 0 writes, and how much of the state this
    rank holds; on a card (both ranks on device 0) also the training
    kernels' launches."""
    d = torch.load(inputs)
    if device == "cuda":
        from chip_smoke import WRAPPERS, reset_launches

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    batch = {k: v.to(device) for k, v in stripe(d["batch"], rank).items()}
    drops = [_to(drop, device) for drop in d["drops"]]
    for mode in modes:
        cfg = step_cfg(mode)
        state = tstep.create_train_state(cfg, build_spec(cfg), state_dict=d["sd"], device=device)
        if device == "cuda":
            reset_launches()
        res = run_steps(state, cfg, batch, drops, accum=2 if mode == "accum" else 1)
        if device == "cuda":
            res["launches"] = {n: WRAPPERS[n].launches for n in
                               ("attention", "attention_bwd", "mlp_tail_train", "t2_upsample")}
        res["npz"] = tcu.save_checkpoint(os.path.join(out, mode), state, 0, cfg)
        # the npz back into a fresh sharded state (each rank takes its share), saved again
        fresh = tstep.create_train_state(cfg, build_spec(cfg), state_dict=d["sd"], device=device)
        tcu.load_checkpoint(res["npz"], fresh)
        res["npz_reloaded"] = tcu.save_checkpoint(os.path.join(out, mode + "_reload"), fresh, 0,
                                                  cfg)
        named = dict(state.model.named_parameters())
        total = sum(p.numel() for p in named.values())
        local_opt = state.optimizer.local
        res["moment_share"] = sum(p.numel() for g in local_opt.param_groups
                                  for p in g["params"]) / total
        res["param_share"] = sum(collectives.local(p).numel() for p in named.values()) / total
        res["dtensor"] = any(isinstance(p, collectives.DTensor) for p in named.values())
        if rank == 0:
            torch.save(res, os.path.join(out, f"{mode}.pt"))


# ----------------------------------------------------------------------------------
# synchronised BatchNorm (the worker of tests/test_torch_batchnorm.py)
# ----------------------------------------------------------------------------------


def sync_bn_worker(rank: int, inputs: str, out: str) -> None:
    """BatchNorm with ``sync`` on this rank's stripe of the global batch in
    ``inputs``: the output, the new state and the gradient of a loss that
    weighs each element, saved to ``out``-rank.npz."""
    from csts_torch.models import batchnorm as bn

    data = np.load(inputs)
    x = torch.from_numpy(stripe({"x": data["x"]}, rank)["x"]).requires_grad_()
    c = x.shape[-1]
    params = {"scale": torch.from_numpy(data["scale"]), "bias": torch.from_numpy(data["bias"])}
    state = bn.bn_state_init(c)
    y, new_state = bn.batch_norm(params, state, x, training=True, sync=True)
    weight = torch.from_numpy(stripe({"w": data["w"]}, rank)["w"])
    (y * weight).sum().backward()
    np.savez(f"{out}-{rank}.npz", y=y.detach().numpy(), mean=new_state["mean"].detach().numpy(),
             var=new_state["var"].detach().numpy(), grad=x.grad.numpy())

"""The orbax checkpoint backend (``csts_torch/utils/orbax_ckpt.py``, over
``torch.distributed.checkpoint``) on the CPU, at ``small_cfg`` with the EMA
on: the counterpart of ``tests/test_checkpoint.py``'s orbax tests.

* One process: a save and a restore into a fresh state give every leaf of
  ``state_leaves`` bit for bit (the bf16 first moment of
  SOLVER.BF16_MOMENTS still bf16), ``latest_step``, ``has_checkpoint``,
  ``max_to_keep=2`` keeping the newest two; a half-written step is not the
  latest; a write that fails raises from ``train()`` and no npz is written;
  ``tester.test`` scores a run of the backend from its latest step.
* ZeRO-1 on 2 ranks: each rank's file holds the moments of its own share
  only, and the restore on 2 ranks equals the state saved.
* Four ranks under FSDP (dp4), dp2 x tp2 under ZeRO-1 and dp2 x tp2 under
  FSDP: no rank's file holds the whole state; FSDP's restores on 2 ranks
  and each layout's in one process equal rank 0's npz of the state saved
  (the counterpart of ``test_orbax_elastic_topology_restore``).

While any restore runs ``collectives.whole`` raises: no rank gathers a
whole tensor. Every restored state is compared by ``state_leaves`` against
the npz the same state wrote (``utils/checkpoint.py``), leaf for leaf.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from torch.distributed.checkpoint import FileSystemReader
from torch.distributed.checkpoint.api import CheckpointException

from csts_torch import presets
from csts_torch.data.synthetic import write_dataset
from csts_torch.eval import tester
from csts_torch.models.csts import CSTS, build_spec
from csts_torch.parallel import collectives, mesh
from csts_torch.tools import inspect_checkpoint
from csts_torch.train import step as tstep
from csts_torch.train import trainer as ttrainer
from csts_torch.utils import checkpoint as tcu
from csts_torch.utils import orbax_ckpt
from test_torch_multiproc import _random_batch, run_ranks

torch.set_num_threads(2)

# the layouts saved on four ranks: name -> (axes, SOLVER.* overrides)
FOUR = {"fsdp4": ({}, {"FSDP": True}),
        "dp2xtp2_zero1": ({"model": 2}, {"ZERO1": True}),
        "dp2xtp2_fsdp": ({"model": 2}, {"FSDP": True})}
AXIS_KW = {"model": "model_parallel", "pipe": "pipe_parallel", "seq": "seq_parallel"}


def _cfg(solver: dict = None, bf16_moments: bool = False):
    cfg = presets.small_cfg(4)
    cfg.SOLVER.EMA_DECAY = 0.9
    cfg.SOLVER.BF16_MOMENTS = bf16_moments
    for k, v in (solver or {}).items():
        setattr(cfg.SOLVER, k, v)
    return cfg


def _state(cfg, seed: int, steps: int = 1):
    """A state from seeded weights after ``steps`` steps on the global
    batch (this rank's stripe of it under a group)."""
    spec = build_spec(cfg)
    state = tstep.create_train_state(cfg, spec, torch.Generator().manual_seed(seed),
                                     device="cpu")
    batch = _random_batch(4, cfg)
    lo, n = mesh.local_rows(4)
    step = tstep.make_train_step(cfg, spec, 10)
    for i in range(steps):
        step(state, {k: v[lo:lo + n] for k, v in batch.items()},
             torch.Generator().manual_seed(3 + i))
    return state


class _NoWhole:
    """``collectives.whole`` raising for the block: no rank gathers."""

    def __enter__(self):
        self.saved = collectives.whole

        def refuse(*a, **k):
            raise AssertionError("a whole tensor was gathered during a restore")

        collectives.whole = refuse

    def __exit__(self, *exc):
        collectives.whole = self.saved


def _assert_leaves_equal(got: list, path: str) -> None:
    with np.load(path) as blob:
        want = [blob[k] for k in sorted(blob.files)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                      err_msg=str(i))


def _rank_files(step_dir: str) -> dict:
    """{rank: bytes of its file}."""
    return {int(n[2:].split("_")[0]): os.path.getsize(os.path.join(step_dir, n))
            for n in os.listdir(step_dir) if n.endswith(".distcp")}


def _files_of(step_dir: str, prefix: str) -> dict:
    """{key: the files holding its chunks} for the keys under ``prefix``."""
    md = FileSystemReader(step_dir).read_metadata()
    out: dict = {}
    for idx, info in md.storage_data.items():
        if idx.fqn.startswith(prefix):
            out.setdefault(idx.fqn, set()).add(info.relative_path)
    return out


# ----------------------------------------------------------------------------------
# one process
# ----------------------------------------------------------------------------------


def test_one_process_round_trip(tmp_path):
    """BF16_MOMENTS and the EMA on, two steps: save (async) then restore
    into a state of other weights: ``state_leaves`` equal to the saved
    state's bit for bit, the first moment still bf16, the step, lr and
    count restored; then ``max_to_keep=2`` over three saves."""
    cfg = _cfg(bf16_moments=True)
    state = _state(cfg, 0, steps=2)
    out = str(tmp_path)
    assert not orbax_ckpt.has_checkpoint(out)
    ck = orbax_ckpt.OrbaxCheckpointer(out, max_to_keep=2)
    assert ck.latest_step() is None
    assert ck.restore(state)[1] == -1
    ck.save(state, 3)
    ck.wait()
    assert ck.latest_step() == 3 and orbax_ckpt.has_checkpoint(out)
    want = tcu.state_leaves(state)
    fresh = tstep.create_train_state(cfg, build_spec(cfg), torch.Generator().manual_seed(9),
                                     device="cpu")
    with _NoWhole():
        _, step = ck.restore(fresh)
    assert step == 3 and fresh.step == state.step == 2
    opt = fresh.optimizer
    assert opt.lr == state.optimizer.lr
    first = opt.local.state[next(fresh.model.parameters())]
    assert first["exp_avg"].dtype == torch.bfloat16 and int(first["step"]) == 2
    got = tcu.state_leaves(fresh)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and np.array_equal(g, w), i
    for s in (6, 9):
        ck.save(state, s)
    ck.close()
    assert orbax_ckpt.committed_steps(out) == [6, 9]
    assert sorted(os.listdir(orbax_ckpt.checkpoint_dir(out))) == ["6", "9"]


def test_half_written_step_is_not_latest(tmp_path):
    """A step directory with every file but the commit marker (a write cut
    before it committed) is not listed: ``latest_step`` names the committed
    one, and a directory holding only such a step has no checkpoint."""
    cfg = _cfg()
    state = _state(cfg, 0)
    out = str(tmp_path / "run")
    ck = orbax_ckpt.OrbaxCheckpointer(out)
    ck.save(state, 4)
    ck.save(state, 8)
    ck.close()
    os.remove(os.path.join(ck.step_dir(8), orbax_ckpt.COMMIT))
    assert sorted(os.listdir(ck.step_dir(8))) == [".metadata", "__0_0.distcp"]
    assert orbax_ckpt.OrbaxCheckpointer(out).latest_step() == 4
    os.makedirs(os.path.join(orbax_ckpt.checkpoint_dir(str(tmp_path / "cut")), "12"))
    assert not orbax_ckpt.has_checkpoint(str(tmp_path / "cut"))
    with pytest.raises(FileNotFoundError, match="not committed"):
        orbax_ckpt.OrbaxCheckpointer(out).restore(state, 8)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("orbax_train"))
    return write_dataset(root, "ego4d", num_clips=4, res=(32, 48), seed=3)


def _train_cfg(split, out: str):
    prefix, splits = split
    cfg = presets.small_cfg(2)
    cfg.DATA.PATH_PREFIX, cfg.DATA.PATH_TO_DATA_DIR = prefix, splits
    cfg.DATA.DECODING_BACKEND = "npy"
    cfg.DATA.GAUSSIAN_KERNEL = 5
    cfg.DATA.TRAIN_JITTER_SCALES = [32, 32]
    cfg.SOLVER.MAX_EPOCH = 2
    cfg.TRAIN.EVAL_PERIOD = 2
    cfg.TRAIN.CHECKPOINT_PERIOD = 1
    cfg.TRAIN.CHECKPOINT_BACKEND = "orbax"
    cfg.DATA_LOADER.NUM_WORKERS = 0
    cfg.TEST.ENABLE = False
    cfg.OUTPUT_DIR = out
    return cfg


def test_failed_write_raises_and_writes_no_npz(split, tmp_path):
    """The first epoch's step (2) cannot be written (a directory stands where
    rank 0's file goes): ``train()`` raises the write's error, commits
    nothing, and falls back to no npz."""
    cfg = _train_cfg(split, str(tmp_path))
    os.makedirs(os.path.join(orbax_ckpt.checkpoint_dir(cfg.OUTPUT_DIR), "2", "__0_0.distcp"))
    with pytest.raises(CheckpointException, match="IsADirectoryError"):
        ttrainer.train(cfg, device="cpu")
    assert orbax_ckpt.committed_steps(cfg.OUTPUT_DIR) == []
    assert not os.path.exists(tcu.checkpoint_dir(cfg.OUTPUT_DIR))


def test_tester_scores_an_orbax_run(split, tmp_path):
    """A run of the orbax backend writes no npz: ``tester.test`` falls back
    to its latest committed step (the JAX tester's order: file sources
    first), here the EMA weights under TEST.USE_EMA, and scores the split
    exactly as it scores an npz of the same final state."""
    cfg = _train_cfg(split, str(tmp_path / "run"))
    cfg.SOLVER.EMA_DECAY = 0.9
    cfg.TEST.USE_EMA = True
    cfg.TEST.BATCH_SIZE = 2
    cfg.TEST.NUM_ENSEMBLE_VIEWS = cfg.TEST.NUM_SPATIAL_CROPS = 1
    state = ttrainer.train(cfg, device="cpu")
    assert orbax_ckpt.committed_steps(cfg.OUTPUT_DIR) == [2, 4]
    got = tester.test(cfg, device="cpu")
    npz = tcu.save_checkpoint(str(tmp_path / "npz"), state, 1, cfg)
    cfg.OUTPUT_DIR, cfg.TEST.CHECKPOINT_FILE_PATH = str(tmp_path / "scored"), npz
    want = tester.test(cfg, device="cpu")
    for k in ("f1", "recall", "precision", "auc", "threshold"):
        assert got[k] == want[k], k


def test_inspect_checkpoint_lists_a_step(tmp_path, capsys):
    """``inspect_checkpoint`` on a step the port wrote: the step, each key's
    global shape and dtype, each rank's file bytes; a directory without
    the commit marker (JAX's orbax format) raises."""
    cfg = _cfg(bf16_moments=True)
    ck = orbax_ckpt.OrbaxCheckpointer(str(tmp_path))
    ck.save(_state(cfg, 0), 2)
    ck.close()
    inspect_checkpoint.main([ck.step_dir(2), "--full"])
    text = capsys.readouterr().out
    assert "step 2" in text and "rank 0:" in text
    qkv = next(n for n, _ in CSTS(build_spec(cfg)).named_parameters() if "qkv.weight" in n)
    assert f"optimizer.exp_avg.{qkv}" in text and "bfloat16" in text
    with pytest.raises(NotImplementedError, match="JAX package's orbax"):
        inspect_checkpoint.main([str(tmp_path)])


# ----------------------------------------------------------------------------------
# several ranks
# ----------------------------------------------------------------------------------


def save_worker(rank: int, out: str, layouts: dict) -> None:
    """Under each layout, one step from seeded weights, then the orbax save
    (step 1, under ``out/<name>``) and rank 0's npz of the same state
    (``out/<name>/npz``); this rank's moments' parameters to
    ``out/<name>/rank<r>.json``."""
    for name, (axes, solver) in layouts.items():
        with mesh.use(mesh.make_mesh(**{AXIS_KW[a]: n for a, n in axes.items()})):
            cfg = _cfg(solver)
            state = _state(cfg, 0)
            ck = orbax_ckpt.OrbaxCheckpointer(os.path.join(out, name))
            ck.save(state, 1)
            ck.close()
            tcu.save_checkpoint(os.path.join(out, name, "npz"), state, 0, cfg)
            opt = state.optimizer
            _, moments = opt.local_moments()
            info = {"moments_of": sorted(moments["exp_avg"]),
                    "split": sum(getattr(p, "model_split", None) is not None
                                 for p in state.model.parameters())}
            with open(os.path.join(out, name, f"rank{rank}.json"), "w") as f:
                json.dump(info, f)


def restore_worker(rank: int, out: str, name: str, solver: dict, axes: dict,
                   tag: str) -> None:
    """A state of other weights under ``axes`` restored from ``out/<name>``
    with ``collectives.whole`` refused, then gathered: rank 0 holds it
    against the layout's npz and writes ``out/<name>/<tag>.json``."""
    with mesh.use(mesh.make_mesh(**{AXIS_KW[a]: n for a, n in axes.items()})):
        cfg = _cfg(solver)
        state = tstep.create_train_state(cfg, build_spec(cfg), torch.Generator().manual_seed(7),
                                         device="cpu")
        ck = orbax_ckpt.OrbaxCheckpointer(os.path.join(out, name))
        with _NoWhole():
            _, step = ck.restore(state)
        ck.close()
        leaves = tcu.state_leaves(state)
        if rank == 0:
            _assert_leaves_equal(leaves, tcu.get_last_checkpoint(os.path.join(out, name, "npz")))
            with open(os.path.join(out, name, f"{tag}.json"), "w") as f:
                json.dump({"step": step, "state_step": state.step}, f)


def zero1_worker(rank: int, out: str) -> None:
    """ZeRO-1 (BF16_MOMENTS) on this group: save as in :func:`save_worker`,
    then restore into a state of other weights on the same ranks."""
    save_worker(rank, out, {"zero1": ({}, {"ZERO1": True})})
    restore_worker(rank, out, "zero1", {"ZERO1": True}, {}, "restored")


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """FOUR's layouts saved on four ranks."""
    out = str(tmp_path_factory.mktemp("orbax_four"))
    run_ranks(save_worker, out, FOUR, world=4, timeout=300)
    return out


def _info(out: str, name: str, world: int) -> list:
    return [json.load(open(os.path.join(out, name, f"rank{r}.json"))) for r in range(world)]


def test_zero1_two_ranks_write_their_moments_and_restore(tmp_path):
    """Each rank's file holds the moments of exactly the parameters its
    share of ``ZeroRedundancyOptimizer``'s partition owns (disjoint, all of
    them together), the parameters and EMA written once between them; the
    restore on the same two ranks equals the saved state."""
    out = str(tmp_path)
    run_ranks(zero1_worker, out, timeout=240)
    info = _info(out, "zero1", 2)
    owned = [set(i["moments_of"]) for i in info]
    assert owned[0] and owned[1] and not owned[0] & owned[1]
    step_dir = os.path.join(out, "zero1", orbax_ckpt.CHECKPOINT_DIR, "1")
    for kind in ("exp_avg", "exp_avg_sq"):
        files = _files_of(step_dir, f"optimizer.{kind}.")
        assert set(files) == {f"optimizer.{kind}.{n}" for n in owned[0] | owned[1]}
        for r in (0, 1):
            for n in owned[r]:
                assert files[f"optimizer.{kind}.{n}"] == {f"__{r}_0.distcp"}, (kind, n)
    for files in _files_of(step_dir, "model.").values():
        assert len(files) == 1  # replicated: written once
    sizes = _rank_files(step_dir)
    assert set(sizes) == {0, 1} and all(b < sum(sizes.values()) for b in sizes.values())
    assert json.load(open(os.path.join(out, "zero1", "restored.json"))) == {"step": 1,
                                                                           "state_step": 1}


@pytest.mark.parametrize("name", list(FOUR))
def test_four_ranks_write_only_their_shards(four, name):
    """No rank's file holds the whole state; under FSDP every parameter's
    chunks come from every rank's file; under tp2 the split leaves' halves
    from two ranks (their data copies written once)."""
    step_dir = os.path.join(four, name, orbax_ckpt.CHECKPOINT_DIR, "1")
    sizes = _rank_files(step_dir)
    total = sum(sizes.values())
    assert all(0 < b < total for b in sizes.values()), sizes
    info = _info(four, name, 4)
    params = _files_of(step_dir, "model.")
    if FOUR[name][1].get("FSDP") and not FOUR[name][0]:
        big = [f for k, f in params.items() if "qkv.weight" in k]
        assert big and all(len(f) == 4 for f in big)
    if FOUR[name][0]:
        assert info[0]["split"] > 0
        split = [f for k, f in params.items() if "mlp.fc1.weight" in k and len(f) > 1]
        assert split, params


def test_fsdp_four_ranks_restore_on_two(four):
    """dp4's FSDP state restored into dp2's FSDP layout, each rank reading
    its own shards, equal to the saved state's npz."""
    run_ranks(restore_worker, four, "fsdp4", {"FSDP": True}, {}, "on_two", timeout=240)
    assert json.load(open(os.path.join(four, "fsdp4", "on_two.json")))["step"] == 1


@pytest.mark.parametrize("name", list(FOUR))
def test_four_ranks_restore_in_one_process(four, name):
    """Each layout's save restored into one process (whole tensors), equal
    to the saved state's npz leaf for leaf."""
    cfg = _cfg(FOUR[name][1])
    state = tstep.create_train_state(cfg, build_spec(cfg), torch.Generator().manual_seed(7),
                                     device="cpu")
    ck = orbax_ckpt.OrbaxCheckpointer(os.path.join(four, name))
    with _NoWhole():
        assert ck.restore(state)[1] == 1
    ck.close()
    assert state.step == 1
    _assert_leaves_equal(tcu.state_leaves(state),
                         tcu.get_last_checkpoint(os.path.join(four, name, "npz")))

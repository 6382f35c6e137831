"""The port's data-parallel training on two gloo ranks against one process and
against the JAX package on a 2-device mesh, on the CPU, fp32.

From one JAX init, one global batch of four and the JAX key stream's
drop-path masks (injected for the global batch; each rank keeps its rows):

* DDP on two ranks at batch 2 each, kldiv+egonce (EgoNCE over the gathered
  embeddings), drop-path 0.2, EMA, two steps: every gradient after step 1
  within 1e-5 of its tensor's max|g| of the port's one process at batch 4,
  the params after step 2 within 1e-6; the stats and params against
  ``make_train_step`` on ``mesh_lib.make_mesh(num_devices=2)`` at
  ``test_torch_train.py``'s two-step bars.
* GradCache (two micro-batches a rank, pass A gathering every rank's
  embeddings) under DDP against one process's single pass: the same bars,
  EgoNCE the global batch's.
* ZeRO-1 (each rank keeps half the moments) and FSDP (each rank holds half
  the params, the EMA sharded too) against DDP: params within 1e-6, as
  ``tests/test_train_step.py:236`` and ``:416`` hold the JAX package's;
  rank 0's npz has DDP's leaf layout and values within the same bars.
* The loader's stripes against ``csts_tpu.data.loader.GazeLoader(process_index=r,
  process_count=2)``'s (host-only numpy, no ``jax.distributed``), and the
  mesh helpers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from csts_tpu.data import loader as jloader
from csts_tpu.models import csts as jcsts
from csts_tpu.parallel import mesh as jmesh
from csts_tpu.train import step as jstep
from csts_torch import presets
from csts_torch.convert.from_jax import state_dict_from_jax
from csts_torch.data import loader as tloader
from csts_torch.models.csts import build_spec
from csts_torch.parallel import collectives, mesh
from csts_torch.tools import run_net
from csts_torch.train import step as tstep
from test_torch_multiproc import run_ranks, run_steps, step_cfg, step_worker
from test_torch_train import _jax_drop_masks

torch.set_num_threads(2)

BATCH = 4
MODES = ("ddp", "accum", "zero1", "fsdp")


def _heatmaps(rng, shape):
    hm = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    return hm / hm.sum(axis=(2, 3), keepdims=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-rank runs of every mode, one process at batch 4, and JAX's
    two steps on a 2-device mesh, from the same init, batch and masks."""
    out = tmp_path_factory.mktemp("parallel")
    jcfg = graft._small_cfg(BATCH)
    jcfg.MVIT.DROPPATH_RATE = 0.2
    jspec = jcsts.build_spec(jcfg)
    state0, tx = jstep.create_train_state(jcfg, jspec, jax.random.PRNGKey(0))
    rng = np.random.default_rng(17)
    batch = {
        "video": rng.standard_normal((BATCH, 8, 32, 32, 3)).astype(np.float32),
        "audio": rng.standard_normal((BATCH, 8, 32, 32, 1)).astype(np.float32),
        "labels_hm": _heatmaps(rng, (BATCH, 8, 8, 8)),
    }
    keys = (jax.random.PRNGKey(31), jax.random.PRNGKey(32))
    drops = [_jax_drop_masks(jspec, k, BATCH) for k in keys]
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state0.params))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    torch.save({"sd": sd, "batch": tbatch, "drops": drops}, out / "inputs.pt")
    run_ranks(step_worker, str(out / "inputs.pt"), str(out), MODES, timeout=300)
    got = {m: torch.load(out / f"{m}.pt") for m in MODES}

    cfg = step_cfg()
    one = tstep.create_train_state(cfg, build_spec(cfg), state_dict=sd, device="cpu")
    ref = run_steps(one, cfg, tbatch, drops)

    jmesh2 = jmesh.make_mesh(num_devices=2)
    train_step = jstep.make_train_step(jcfg, jspec, tx, steps_per_epoch=10)
    jstats = []
    with jax.sharding.set_mesh(jmesh2):
        st = jax.device_put(state0, jmesh.replicated(jmesh2))
        jb = jmesh.shard_batch(jmesh2, batch)
        for key in keys:
            st, stats, _ = train_step(st, jb, key)
            jstats.append({k: float(v) for k, v in stats.items()})
    jparams = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, st.params))
    return {"got": got, "one": ref, "jax": {"stats": jstats, "params": jparams}, "cfg": cfg}


def _assert_grads(got: dict, want: dict) -> None:
    """Each gradient within 1e-5 of its tensor's max|g| (fp32 sums in
    another order: over two ranks' rows, then the ranks' mean), plus 1e-8
    of the largest gradient anywhere: the pooled keys' norm biases have an
    exact gradient of 0 (the softmax ignores a shift shared by all keys),
    so both sides give rounding noise there (~1e-17 against ~1e-11)."""
    floor = 1e-8 * max(float(w.abs().max()) for w in want.values())
    for n, w in want.items():
        bar = 1e-5 * float(w.abs().max()) + floor
        err = float((got[n] - w).abs().max())
        assert err <= bar, (n, err, bar)


def _assert_params(got: dict, want: dict, atol: float, grads: dict, lr: float) -> None:
    """Each param within ``atol``, except the elements whose step-1
    gradient is below 100·eps (1e-6) of Adam: its first step is
    lr·g / (|g| + 1e-8), which rounding noise in such a g (the pooled keys'
    norm biases, whose exact gradient is 0, and a few weights near 1e-9)
    moves by up to lr on either side, so the bar there is 2·lr a step
    (test_torch_train.py's bar for the whole tensor)."""
    for n, w in want.items():
        bar = torch.where(grads[n].abs() < 1e-6, torch.tensor(2 * 2 * lr), torch.tensor(atol))
        err = (got[n] - w).abs()
        assert bool((err <= bar).all()), (n, float(err.max()), float((err - bar).max()))


@pytest.mark.parametrize("mode", ["ddp", "accum"])
def test_two_ranks_match_one_process(runs, mode):
    """DDP (and GradCache under DDP) on two ranks at batch 2 each against
    one process at batch 4: the loss and EgoNCE of the global batch within
    1e-5 relative, the gradients after step 1 and the params after step 2
    at the bars above."""
    got, want = runs["got"][mode], runs["one"]
    for g, w in zip(got["stats"], want["stats"]):
        for k in ("loss", "kldiv_loss", "egonce_loss", "grad_norm"):
            assert g[k] == pytest.approx(w[k], rel=1e-5), (k, g[k], w[k])
        assert g["lr"] == w["lr"]
    _assert_grads(got["grads"], want["grads"])
    _assert_params(got["params"], want["params"], 1e-6, want["grads"], runs["cfg"].SOLVER.BASE_LR)


def test_two_ranks_match_jax_two_device_mesh(runs):
    """DDP on two ranks against ``make_train_step`` with the batch sharded
    over a 2-device mesh: step 1's stats within 1e-5, step 2's within 1e-4
    relative, each param within 2·BASE_LR a step (test_torch_train.py's
    bars for two steps)."""
    got, want = runs["got"]["ddp"], runs["jax"]
    for g, w, rel in zip(got["stats"], want["stats"], (1e-5, 1e-4)):
        for k in ("loss", "kldiv_loss", "egonce_loss", "grad_norm", "lr"):
            assert g[k] == pytest.approx(w[k], rel=rel), (k, g[k], w[k])
    lr = runs["cfg"].SOLVER.BASE_LR
    _assert_params(got["params"], want["params"], 2 * 2 * lr, got["grads"], lr)


@pytest.mark.parametrize("mode", ["zero1", "fsdp"])
def test_sharded_modes_match_ddp(runs, mode):
    """ZeRO-1 and FSDP from the same weights, batch and masks as DDP: the
    params after two steps within 1e-6 of DDP's, while each rank keeps half
    the moments (ZeRO-1: its share of whole parameters; FSDP: its shard of
    every parameter, the params themselves too). Rank 0's npz has DDP's
    leaf layout (3P+4+P with the EMA), and the npz loaded back into a fresh
    state of the same mode (each rank its share) saves bit for bit."""
    got, ddp = runs["got"][mode], runs["got"]["ddp"]
    _assert_params(got["params"], ddp["params"], 1e-6, ddp["grads"], runs["cfg"].SOLVER.BASE_LR)
    assert ddp["moment_share"] == 1.0 and ddp["param_share"] == 1.0 and not ddp["dtensor"]
    if mode == "zero1":
        assert 0.3 < got["moment_share"] < 0.7 and got["param_share"] == 1.0
    else:
        assert got["dtensor"] and got["param_share"] <= 0.5 + 0.01
    a, b = np.load(got["npz"]), np.load(ddp["npz"])
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    # the params leaves are the params above, in the JAX tree's order and layout
    p = len(ddp["params"])
    assert len(b.files) == 4 * p + 4
    for k in sorted(b.files)[:p]:
        assert float(np.abs(a[k] - b[k]).max()) <= 2 * 2 * runs["cfg"].SOLVER.BASE_LR, k
    c = np.load(got["npz_reloaded"])
    assert sorted(c.files) == sorted(a.files)
    for k in a.files:
        np.testing.assert_array_equal(c[k], a[k], err_msg=k)


# ----------------------------------------------------------------------------------
# the loader's stripes, the mesh helpers
# ----------------------------------------------------------------------------------


class _Rows:
    """A dataset of ``n`` rows, each its index and three draws of its rng."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index: int, rng=None):
        zero = np.zeros(1)
        return {"index": np.int64(index), "video": rng.random(3), "audio": zero,
                "labels": zero, "labels_hm": zero}


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_stripes_match_gaze_loader(shuffle, drop_last):
    """Rank r of 2 reads rows [r·lb, (r+1)·lb) of each global batch of 6, as
    ``GazeLoader(process_index=r, process_count=2)`` does, with the same
    per-sample draws (keyed by global position). JAX wrap-pads the short
    last batch; the port's stripes stop at the split's end (the JAX tester
    masks the pad rows by position), so rank 1 has no rows of it."""
    n, gb = 15, 6
    for r in range(2):
        jl = jloader.GazeLoader(_Rows(n), gb, shuffle, num_workers=1, seed=7,
                                drop_last=drop_last, process_index=r, process_count=2)
        sampler = tloader.EpochBatches(n, gb, shuffle, 7, drop_last, rank=r, world=2)
        items = tloader.SeededItems(_Rows(n), 7)
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            sampler.epoch = epoch
            want = list(jl)
            got = [[items[key] for key in keys] for keys in sampler]
            assert sampler.num_batches() == len(jl)
            assert len(got) == len(sampler)
            for b, w in enumerate(want):
                real = b * gb + r * (gb // 2) + np.arange(gb // 2) < n  # JAX's pad rows
                if b >= len(got):
                    assert not real.any()
                    continue
                assert len(got[b]) == int(real.sum())
                np.testing.assert_array_equal([g["index"] for g in got[b]], w["index"][real])
                np.testing.assert_array_equal(np.stack([g["video"] for g in got[b]]),
                                              w["video"][real])
    with pytest.raises(ValueError, match="divide"):
        tloader.EpochBatches(n, 5, False, 7, False, rank=0, world=2)


def test_mesh_helpers(monkeypatch, tmp_path):
    """Without a group: one rank, the whole batch, the model unwrapped. The
    model/seq/pipe axes must divide the run's ranks, and more local ranks than
    visible cards raise. ``init_from_cfg`` starts a one-rank gloo group on
    the CPU (run_net's path) and a step wraps the model in DDP there."""
    cfg = presets.small_cfg(4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="local rank 1"):
        mesh.init_from_cfg(cfg, "cuda", local_rank=1)
    (tmp_path / "cfg.yaml").write_text("TRAIN:\n  BATCH_SIZE: 4\n")
    with pytest.raises(RuntimeError, match="NUM_DEVICES 2 ranks a shard, 1 cards visible"):
        run_net.main(["--device", "cuda", "--cfg", str(tmp_path / "cfg.yaml"), "NUM_DEVICES", "2",
                      "OUTPUT_DIR", str(tmp_path / "out")])
    monkeypatch.undo()
    assert mesh.local_rows(4) == (0, 4) and collectives.world_size() == 1
    assert collectives.gather_objects("x") == ["x"] and not collectives.any_rank(False)
    # the model axis is ported (tests/test_torch_model_axes.py): the guard
    # is now that the axes divide the run's ranks
    cfg.PARALLEL.MODEL = 2
    with pytest.raises(ValueError, match="divide"):
        mesh.check_axes(cfg)
    cfg.NUM_DEVICES = 2
    mesh.check_axes(cfg)
    cfg.PARALLEL.MODEL, cfg.NUM_DEVICES = 1, 1
    assert mesh.init_from_cfg(cfg, "cpu") == torch.device("cpu")
    try:
        assert dist.get_backend() == "gloo" and collectives.world_size() == 1
        state = tstep.create_train_state(cfg, build_spec(cfg), device="cpu")
        assert isinstance(state.net, torch.nn.parallel.DistributedDataParallel)
        assert state.net.module is state.model
    finally:
        dist.destroy_process_group()
    assert jnp.ones(1).shape == (1,)  # JAX stays on the CPU beside the group

"""``TENSORBOARD.ENABLE`` in the port (``csts_torch/utils/tensorboard.py``)
against ``csts_tpu.utils.tensorboard``: the counterparts of
``tests/test_tensorboard.py``.

* With tensorboard hidden, the ``scalars.jsonl`` records of a 2-epoch
  ``train()`` from one JAX-written init npz have JAX's keys, and its values
  at ``test_torch_trainer.py::test_trainer_tracks_jax``'s bars (loss 1e-5
  relative, lr 1e-6, F1, recall and precision 5e-3); ``ts`` apart.
* With tensorboard present, the event file holds the same tags and values.
* ``_heatmap`` and ``_make_grid`` within 1e-6 of JAX's (matplotlib's viridis).
* The figure methods without a SummaryWriter, ``class_metrics``' ``plot_*``
  without matplotlib and ``plot_logs``' message.
"""

from __future__ import annotations

import builtins
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from csts_tpu.config import get_cfg as jget_cfg
from csts_tpu.eval import class_metrics as jcm
from csts_tpu.models import csts as jcsts
from csts_tpu.train import step as jstep
from csts_tpu.train import trainer as jtrainer
from csts_tpu.utils import checkpoint as jcu
from csts_tpu.utils import tensorboard as jtb
from csts_torch.config import get_cfg
from csts_torch.data.synthetic import write_dataset
from csts_torch.eval import class_metrics as tcm
from csts_torch.train import trainer as ttrainer
from csts_torch.utils import tensorboard as ttb
from test_torch_trainer import _np, _train_cfgs

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """test_torch_trainer.py's split: crops with no resize, so both loaders
    give the same batches."""
    root = str(tmp_path_factory.mktemp("tb"))
    return write_dataset(root, "ego4d", num_clips=4, res=(32, 48), seed=3)


def _hide_tensorboard(monkeypatch):
    real_import = builtins.__import__

    def block(name, *a, **k):
        if name.split(".")[0] == "tensorboard" or name.startswith("torch.utils.tensorboard"):
            raise ImportError("hidden for the test")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", block)


def _jsonl(cfg):
    with open(os.path.join(cfg.TENSORBOARD.LOG_DIR, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def _event_scalars(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


def test_trainer_scalars_match_jax(split, tmp_path, monkeypatch):
    jcfg, tcfg = _train_cfgs(split, tmp_path)
    jcfg.MODEL.LOSS_FUNC = tcfg.MODEL.LOSS_FUNC = "kldiv+egonce"
    state, _ = jstep.create_train_state(jcfg, jcsts.build_spec(jcfg), jax.random.PRNGKey(0))
    init = jcu.save_checkpoint(str(tmp_path / "init"), _np(state), 0, jcfg)
    for c in (jcfg, tcfg):
        c.TRAIN.CHECKPOINT_FILE_PATH = init
        c.TENSORBOARD.ENABLE = True
        c.TENSORBOARD.LOG_DIR = os.path.join(c.OUTPUT_DIR, "tb")
    with monkeypatch.context() as m:
        _hide_tensorboard(m)
        jtrainer.train(jcfg)
        ttrainer.train(tcfg, device="cpu")
    want, got = _jsonl(jcfg), _jsonl(tcfg)
    assert len(got) == len(want) == 4
    tags = {"Train/loss", "Train/lr", "Train/F1", "Train/Recall", "Train/Precision",
            "Train/kldiv_loss", "Train/nce_loss"}
    for g, w in zip(got, want):
        assert set(g) == set(w) == tags | {"step", "ts"}
        assert g["step"] == w["step"]
        for k in ("Train/loss", "Train/kldiv_loss", "Train/nce_loss"):
            assert g[k] == pytest.approx(w[k], rel=1e-5), k
        assert g["Train/lr"] == pytest.approx(w["Train/lr"], rel=1e-6)
        for k in ("Train/F1", "Train/Recall", "Train/Precision"):
            assert abs(g[k] - w[k]) <= 5e-3, k
    assert [r["step"] for r in got] == [0, 1, 2, 3]

    # tensorboard present: the event file's tags and values are the JSONL's
    tcfg.OUTPUT_DIR = str(tmp_path / "port_tb")
    tcfg.TENSORBOARD.LOG_DIR = os.path.join(tcfg.OUTPUT_DIR, "tb")
    ttrainer.train(tcfg, device="cpu")
    assert not os.path.exists(os.path.join(tcfg.TENSORBOARD.LOG_DIR, "scalars.jsonl"))
    events = _event_scalars(tcfg.TENSORBOARD.LOG_DIR)
    assert set(events) == tags
    for tag, series in events.items():
        assert [s for s, _ in series] == [0, 1, 2, 3]
        np.testing.assert_allclose([v for _, v in series], [r[tag] for r in got],
                                   rtol=1e-6, err_msg=tag)


def _tb_cfg(mod_get_cfg, tmp_path, name):
    cfg = mod_get_cfg()
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.TENSORBOARD.LOG_DIR = str(tmp_path / name)
    cfg.MODEL.NUM_CLASSES = 5
    cfg.TENSORBOARD.CONFUSION_MATRIX.ENABLE = True
    cfg.TENSORBOARD.HISTOGRAM.ENABLE = True
    cfg.TENSORBOARD.HISTOGRAM.TOPK = 3
    p = tmp_path / "names.json"
    p.write_text(json.dumps({f"cls{i}": i for i in range(5)}))
    cfg.TENSORBOARD.CLASS_NAMES_PATH = str(p)
    s = tmp_path / "subset.json"
    s.write_text(json.dumps({"a": [3, 1], "b": [1, 4]}))
    cfg.TENSORBOARD.CONFUSION_MATRIX.SUBSET_PATH = str(s)
    return cfg


@pytest.mark.parametrize("seed", [0, 1])
def test_heatmap_and_grid_match_jax(seed):
    rng = np.random.default_rng(seed)
    for shape in ((4, 6), (17, 3), (1, 1)):
        a = rng.standard_normal(shape).astype(np.float32)
        got, want = ttb._heatmap(a), jtb._heatmap(a)
        assert got.dtype == want.dtype == np.float32 and got.shape == (3, *shape)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # every level, its edges included
    ramp = np.linspace(0, 1, 1031, dtype=np.float32)[None]
    np.testing.assert_allclose(ttb._heatmap(ramp), jtb._heatmap(ramp), atol=1e-6, rtol=0)
    tiles = rng.random((5, 4, 4)).astype(np.float32)
    for nrow, norm, heat in ((2, True, True), (3, False, True), (2, False, False)):
        got = ttb._make_grid(tiles, nrow=nrow, normalize=norm, heat_map=heat)
        want = jtb._make_grid(tiles, nrow=nrow, normalize=norm, heat_map=heat)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_writer_figures_and_names(tmp_path, monkeypatch):
    """Class names and subsets as JAX reads them; with a SummaryWriter the
    image methods write their tags (the figures need matplotlib, so
    ``plot_eval`` writes none); with tensorboard hidden every figure method
    returns at once and the scalars go to JSONL."""
    w = ttb.TensorboardWriter(_tb_cfg(get_cfg, tmp_path, "t"))
    jw = jtb.TensorboardWriter(_tb_cfg(jget_cfg, tmp_path, "j"))
    assert w.class_names == jw.class_names == [f"cls{i}" for i in range(5)]
    assert w.cm_subset == jw.cm_subset == [3, 1, 4]
    rng = np.random.default_rng(0)
    w.plot_eval(rng.standard_normal((40, 5)).astype(np.float32), rng.integers(0, 5, 40), 1)
    w.plot_weights_and_activations(
        {"w1d": rng.standard_normal(16).astype(np.float32),
         "w2d": rng.standard_normal((6, 6)).astype(np.float32),
         "act4d": rng.standard_normal((2, 3, 4, 4)).astype(np.float32)},
        tag="layers/", global_step=1, batch_idx=0)
    w.add_scalars({"loss": 1.5}, global_step=3)
    w.close()
    jw.close()
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(tmp_path / "t"))
    acc.Reload()
    assert sorted(acc.Tags()["images"]) == ["layers/act4d", "layers/w1d", "layers/w2d"]
    assert acc.Scalars("loss")[0].value == 1.5

    _hide_tensorboard(monkeypatch)
    w = ttb.TensorboardWriter(_tb_cfg(get_cfg, tmp_path, "hidden"))
    assert w._writer is None
    w.add_scalars({"loss": 1.5, "lr": 0.25}, global_step=3)
    w.plot_eval(np.zeros((4, 5)), np.zeros(4, np.int64))
    w.add_video(np.zeros((1, 2, 4, 4, 3), np.uint8))
    w.plot_weights_and_activations({"x": np.ones((3, 3))})
    w.add_ndim_array(np.ones((2, 3, 3)), "y")
    w.close()
    assert os.listdir(tmp_path / "hidden") == ["scalars.jsonl"]
    rec = json.loads((tmp_path / "hidden" / "scalars.jsonl").read_text())
    assert rec["loss"] == 1.5 and rec["lr"] == 0.25 and rec["step"] == 3


def test_plots_without_matplotlib(tmp_path, monkeypatch):
    """``plot_confusion_matrix`` and ``plot_topk_histogram`` take JAX's path
    without matplotlib: None and no file; the confusion matrix is JAX's."""
    rng = np.random.default_rng(1)
    preds, labels = rng.integers(0, 4, 50), rng.integers(0, 4, 50)
    cm = tcm.confusion_matrix(preds, labels, 4)
    np.testing.assert_array_equal(cm, jcm.confusion_matrix(preds, labels, 4))
    real_import = builtins.__import__

    def block(name, *a, **k):
        if name.startswith("matplotlib"):
            raise ImportError("hidden for the test")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", block)
    for mod in (tcm, jcm):
        assert mod.plot_confusion_matrix(cm, list("abcd"), path=str(tmp_path / "cm.png")) is None
        assert mod.plot_topk_histogram("a", cm[0], 3, list("abcd"),
                                       path=str(tmp_path / "h.png")) is None
    assert os.listdir(tmp_path) == []


def test_plot_logs_says_csvs_only(tmp_path):
    """The port's plot_logs writes the CSVs and says, as JAX's tool does
    without matplotlib, that it makes no figures."""
    log = tmp_path / "stdout.log"
    log.write_text("[x] INFO: json_stats: " + json.dumps(
        {"_type": "train_iter", "epoch": "1/1", "iter": "1/1", "loss": 0.5}) + "\n")
    r = subprocess.run([sys.executable, "-m", "csts_torch.tools.plot_logs", str(log), "--out",
                        str(tmp_path / "a")], cwd=REPO, capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0, r.stderr
    with open(os.path.join(REPO, "tools", "plot_logs.py")) as f:
        assert '"matplotlib not available — CSVs only"' in f.read()
    assert "matplotlib not available — CSVs only" in r.stderr
    assert os.listdir(tmp_path / "a") == ["train_iter.csv"]

"""The port's eval entry point against the JAX package's on the CPU:
``csts_torch.eval.tester.test(cfg, device="cpu")`` against
``csts_tpu.eval.tester.test(cfg)`` on one synthetic fixture (npy backend,
source short side 32 = the crop, so nothing resizes) and one ``.pyth`` written
from ``csts_init`` by ``csts_tpu.convert.to_torch.export_csts_state_dict``,
fp32, at one view and at two; then ``python -m csts_torch.tools.run_net``
and the checkpoint chain.

Bars: ``test_final``'s threshold equal, f1, recall, precision and AUC within
1e-6 (the two forwards agree within 5e-4 in fp32 logits, tests/test_torch_model.py;
after the softmax and the rescale the rows' pixels pass the same thresholds
here, and the per-batch float32 sums run in another order); the
``SAVE_RESULTS`` npz's index, label_xy and gaze_type equal.
"""

import logging
import os

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as graft
from csts_tpu.convert.to_torch import export_csts_state_dict
from csts_tpu.eval.tester import test as jax_test
from csts_tpu.models import csts as jcsts
from csts_torch import presets
from csts_torch.data.synthetic import write_dataset
from csts_torch.eval.tester import test as port_test
from csts_torch.models.csts import CSTS, build_spec
from csts_torch.tools import run_net
from csts_torch.utils import checkpoint as cu

torch.set_num_threads(2)

TOL = 1e-6


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """Five clips (batch 4 leaves a final batch of one; the JAX loader
    wrap-pads it) and the weights as a .pyth."""
    root = str(tmp_path_factory.mktemp("eval"))
    prefix, splits = write_dataset(root, "ego4d", num_clips=5, res=(32, 48), seed=11)
    cfg = graft._small_cfg(4)
    params = jcsts.csts_init(jax.random.PRNGKey(0), jcsts.build_spec(cfg))
    sd = export_csts_state_dict(jax.tree_util.tree_map(np.asarray, params))
    path = os.path.join(root, "weights.pyth")
    torch.save({"model_state": {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}}, path)
    return root, prefix, splits, path


def _cfgs(fixture, out, views=1, dataset="ego4d_av_gaze_forecast"):
    root, prefix, splits, path = fixture
    pair = graft._small_cfg(4), presets.small_cfg(4)
    for c in pair:
        c.DATA.PATH_PREFIX, c.DATA.PATH_TO_DATA_DIR = prefix, splits
        c.DATA.DECODING_BACKEND = "npy"
        c.DATA.GAUSSIAN_KERNEL = 5
        c.TRAIN.ENABLE = False
        c.TEST.DATASET = dataset
        c.TEST.BATCH_SIZE = 4
        c.TEST.NUM_ENSEMBLE_VIEWS = views
        c.TEST.NUM_SPATIAL_CROPS = 1
        c.TEST.CHECKPOINT_FILE_PATH = path
        c.TEST.SAVE_RESULTS_PATH = "results"
        c.DATA_LOADER.NUM_WORKERS = 0
        c.OUTPUT_DIR = str(out)
        c.LOG_PERIOD = 1
    return pair


def _close(got, want):
    assert got["_type"] == want["_type"] == "test_final"
    assert got["threshold"] == want["threshold"]
    for k in ("f1", "recall", "precision", "auc"):
        assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])


@pytest.mark.parametrize("views,dataset", [(1, "ego4d_av_gaze_forecast"), (2, "ego4d_av_gaze")])
def test_tester_matches_jax(fixture, tmp_path, views, dataset):
    jcfg, tcfg = _cfgs(fixture, tmp_path / "jax", views, dataset)
    tcfg.OUTPUT_DIR = str(tmp_path / "port")
    want = jax_test(jcfg)
    got = port_test(tcfg, device="cpu")
    _close(got, want)
    jres = np.load(os.path.join(jcfg.OUTPUT_DIR, "results.npz"))
    tres = np.load(os.path.join(tcfg.OUTPUT_DIR, "results.npz"))
    assert list(tres["index"]) == list(range(5 * views))
    for key in ("index", "label_xy", "gaze_type"):
        np.testing.assert_array_equal(tres[key], jres[key], err_msg=key)
    assert tres["pred_xy"].shape == jres["pred_xy"].shape
    with open(os.path.join(tcfg.OUTPUT_DIR, "stdout.log")) as f:
        log = f.read()
    assert '"_type": "test_final"' in log and '"_type": "test_iter"' in log


def test_run_net_scores_the_split(fixture, tmp_path, monkeypatch):
    """The CLI with a YAML and overrides: CUDA unless --device is given, an
    error for a training option not ported, several shards refused without
    a rendezvous (``--init-method``), the tester's stats for TEST.ENABLE."""
    _, tcfg = _cfgs(fixture, tmp_path)
    yaml_path = tmp_path / "cfg.yaml"
    yaml_path.write_text(
        "DATA:\n"
        f"  PATH_PREFIX: {tcfg.DATA.PATH_PREFIX}\n"
        f"  PATH_TO_DATA_DIR: {tcfg.DATA.PATH_TO_DATA_DIR}\n"
        "  DECODING_BACKEND: npy\n  GAUSSIAN_KERNEL: 5\n  TRAIN_CROP_SIZE: 32\n"
        "  TEST_CROP_SIZE: 32\n  AUDIO_FREQ_BINS: 32\n  AUDIO_WINDOW: 32\n"
        "MVIT:\n  DEPTH: 4\n  EMBED_DIM: 16\n  PATCH_PADDING: [1, 3, 3]\n  CLS_EMBED_ON: False\n"
        "  SEP_POS_EMBED: True\n  DIM_MUL: [[1, 2.0], [2, 2.0], [3, 2.0]]\n"
        "  HEAD_MUL: [[1, 2.0], [2, 2.0], [3, 2.0]]\n  POOL_KVQ_KERNEL: [3, 3, 3]\n"
        "  POOL_KV_STRIDE_ADAPTIVE: [1, 8, 8]\n"
        "  POOL_Q_STRIDE: [[1, 1, 2, 2], [2, 1, 2, 2], [3, 1, 2, 2]]\n"
        "TEST:\n  BATCH_SIZE: 4\n  NUM_ENSEMBLE_VIEWS: 1\n  NUM_SPATIAL_CROPS: 1\n"
        "MODEL:\n  LOSS_FUNC: kldiv+egonce\n"
        "DATA_LOADER:\n  NUM_WORKERS: 0\n")
    args = ["--cfg", str(yaml_path), "TRAIN.ENABLE", "False",
            "TEST.CHECKPOINT_FILE_PATH", fixture[3], "OUTPUT_DIR", str(tmp_path / "cli")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_net.main(args)
    with pytest.raises(NotImplementedError, match="no orbax"):
        run_net.main(["--device", "cpu", "--cfg", str(yaml_path),
                      "TRAIN.CHECKPOINT_BACKEND", "orbax", "OUTPUT_DIR", str(tmp_path / "t")])
    with pytest.raises(ValueError, match="init-method"):
        run_net.main(["--device", "cpu", "--num-shards", "2"] + args)
    got = run_net.main(["--device", "cpu"] + args)
    tcfg.OUTPUT_DIR = str(tmp_path / "direct")
    tcfg.TEST.SAVE_RESULTS_PATH = ""
    want = port_test(tcfg, device="cpu")
    for k in ("f1", "recall", "precision", "auc", "threshold"):
        assert got[k] == want[k], k


def test_tester_raises_without_cuda(fixture, tmp_path, monkeypatch):
    _, tcfg = _cfgs(fixture, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_test(tcfg)


def test_checkpoint_chain(fixture, tmp_path, caplog):
    """TEST path, then OUTPUT_DIR's latest (the JAX package's epoch .npz),
    then TRAIN path, then random init; TEST.USE_EMA on a state dict scores
    the raw weights with a warning."""
    _, tcfg = _cfgs(fixture, tmp_path)
    model = CSTS(build_spec(tcfg))
    caplog.set_level(logging.INFO)
    tcfg.TEST.USE_EMA = True
    assert cu.load_test_checkpoint(tcfg, model) == fixture[3]
    assert "carries no EMA weights" in caplog.text
    sd = model.state_dict()
    ref = cu.load_state_dict_file(fixture[3])
    assert all(torch.equal(sd[k], ref[k]) for k in ref)

    tcfg.TEST.CHECKPOINT_FILE_PATH = ""
    tcfg.TRAIN.CHECKPOINT_FILE_PATH = fixture[3]
    assert cu.resolve_test_checkpoint(tcfg) == fixture[3]
    os.makedirs(cu.checkpoint_dir(tcfg.OUTPUT_DIR))
    for epoch in (1, 2):
        open(os.path.join(cu.checkpoint_dir(tcfg.OUTPUT_DIR),
                          f"checkpoint_epoch_{epoch:05d}.npz"), "w").close()
    latest = cu.resolve_test_checkpoint(tcfg)
    assert latest.endswith("checkpoint_epoch_00002.npz")
    # an npz is read (tests/test_torch_checkpoint.py); this one is empty
    with pytest.raises(Exception):
        cu.load_test_checkpoint(tcfg, model)

    tcfg.TRAIN.CHECKPOINT_FILE_PATH = ""
    tcfg.OUTPUT_DIR = str(tmp_path / "empty")
    assert cu.load_test_checkpoint(tcfg, model) is None
    assert "random initialization" in caplog.text


def test_bench_checks_before_timing(monkeypatch):
    """The bench's result check and timed loop on the CPU (the reduced model,
    plain twins, no device metric); a planted fault, the reference from
    another seed's weights (what a model that loaded the wrong checkpoint
    gives), misses the logits bar and stops before timing; the command itself
    raises without a card."""
    from csts_torch import tools
    from csts_torch.tools import bench

    res = bench.run(1, "cpu", small=True, log=print)
    assert res["ok"] and res["clips_per_sec"] > 0, res
    assert res["logits_max_abs_diff"] < res["logits_bar"] and res["decided_frames"] > 0, res
    build = bench.build

    def planted(batch, device, small=False, seed=0):
        cfg, spec, _, model, video, audio = build(batch, device, small, seed)
        return cfg, spec, build(batch, device, small, seed + 1)[2], model, video, audio

    monkeypatch.setattr(bench, "build", planted)
    res = bench.run(1, "cpu", small=True, log=print)
    assert not res["ok"] and "clips_per_sec" not in res
    assert res["logits_max_abs_diff"] > 2 * res["logits_bar"], res
    print(f"softmax alone under the planted fault: {res['softmax_max_abs_diff']:.3g} "
          f"(bar {tools.SOFTMAX_BAR})")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--batch", "1"])

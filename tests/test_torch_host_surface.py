"""The rest of the port's model and host surface against the JAX package on
the CPU: the class metrics, the misc helpers (parameter counts, the eval
cadence, FLOPs against an analytic count, the loader benchmark), the native
loader ops (built by g++ from the port's own source, bit-equal to the JAX
package's build and to the port's numpy twins; a failed build raises), the
Caffe2 converter, the config printer and its YAML writer, the log parser, and
the loader benchmark tools."""

import csv
import importlib.util
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import yaml

import jax

from csts_tpu import native as jnative
from csts_tpu.config import get_cfg as jax_get_cfg
from csts_tpu.config import load_config as jax_load_config
from csts_tpu.config.__main__ import main as jax_config_main
from csts_tpu.convert import from_caffe2 as jc2
from csts_tpu.eval import class_metrics as jcm
from csts_tpu.models import csts as jcsts
from csts_tpu.utils import misc as jmisc
from csts_torch import native as tnative
from csts_torch import presets
from csts_torch.config import get_cfg, load_config, yaml_subset
from csts_torch.convert import from_caffe2 as tc2
from csts_torch.data.synthetic import write_dataset
from csts_torch.eval import class_metrics as tcm
from csts_torch.models.build import build_model
from csts_torch.native import build as nbuild
from csts_torch.native import twins
from csts_torch.tools import bench_loader_scaling, benchmark_loader, plot_logs
from csts_torch.utils import misc as tmisc
from csts_torch.utils import procs

import __graft_entry__ as graft

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "configs", "Ego4D", "CSTS_Ego4D_Gaze_Forecast.yaml")


# ----------------------------------------------------------------------------------
# class metrics
# ----------------------------------------------------------------------------------


@pytest.mark.parametrize("ties", [False, True])
def test_class_metrics_match_jax(ties):
    rng = np.random.default_rng(0)
    preds = rng.standard_normal((40, 7)).astype(np.float32)
    if ties:  # equal scores rank the lower class first on both sides, and
        # -0.0 below +0.0 (the rounding leaves both)
        preds = np.round(preds * 2) / 2
        preds[:5] = 0.0
        preds[5, :3] = np.nan
    labels = rng.integers(0, 7, 40)
    ks = (1, 2, 5)
    got = tcm.topks_correct(torch.from_numpy(preds), torch.from_numpy(labels), ks)
    want = jcm.topks_correct(jax.numpy.asarray(preds), jax.numpy.asarray(labels), ks)
    assert [int(g) for g in got] == [int(w) for w in want]
    assert tcm.topk_accuracies(preds, labels, ks) == jcm.topk_accuracies(preds, labels, ks)
    assert tcm.topk_errors(preds, labels, ks) == jcm.topk_errors(preds, labels, ks)
    np.testing.assert_array_equal(tcm.confusion_matrix(preds, labels, 7),
                                  jcm.confusion_matrix(preds, labels, 7))
    np.testing.assert_array_equal(tcm.confusion_matrix(preds.argmax(-1), labels, 7),
                                  jcm.confusion_matrix(preds.argmax(-1), labels, 7))


def test_class_metrics_reference_case():
    """tests/test_mvit_classifier.py's planted case."""
    preds = np.zeros((6, 4), np.float32)
    labels = np.array([0, 1, 2, 3, 0, 1])
    preds[np.arange(6), labels] = 1.0
    preds[5] = [0.9, 0.5, 0, 0]
    top1, top2 = tcm.topk_accuracies(preds, labels, ks=(1, 2))
    assert abs(top1 - 5 / 6 * 100) < 1e-6 and abs(top2 - 100.0) < 1e-6
    cm = tcm.confusion_matrix(preds, labels, 4)
    assert cm.sum() == 6 and cm[1, 0] == 1


# ----------------------------------------------------------------------------------
# misc helpers
# ----------------------------------------------------------------------------------


def test_params_count_and_bytes_match_jax():
    jcfg = graft._small_cfg(1)
    params = jcsts.csts_init(jax.random.PRNGKey(0), jcsts.build_spec(jcfg))
    model = build_model(presets.small_cfg(1), device="cpu")
    assert tmisc.params_count(model) == jmisc.params_count(params)
    assert tmisc.params_bytes(model) == jmisc.params_bytes(params)
    sd = model.state_dict()
    assert tmisc.params_count(sd) == tmisc.params_count(model)
    half = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    assert tmisc.params_bytes([half]) == tmisc.params_bytes(model) // 2


def test_is_eval_epoch_matches_jax():
    for max_epoch, period in ((15, 10), (10, 3), (4, 1), (7, 20)):
        tcfg, jcfg = get_cfg(), jax_get_cfg()
        for c in (tcfg, jcfg):
            c.SOLVER.MAX_EPOCH, c.TRAIN.EVAL_PERIOD = max_epoch, period
        for epoch in range(max_epoch + 2):
            assert tmisc.is_eval_epoch(tcfg, epoch) == jmisc.is_eval_epoch(jcfg, epoch)


def _classifier_flops(spec, batch: int) -> int:
    """Multiply-adds x2 of the classifier's convolutions and products, from
    its spec: the patch embed, each block's qkv, pooling convolutions,
    attention (two products), proj and MLP (+ the dim-change proj), and the
    head. The norms, the max-pool skip and the mean are not products."""
    prod = lambda xs: int(np.prod(xs))  # noqa: E731
    pool_out = lambda thw, b, k, s: tuple(  # noqa: E731
        (d + 2 * (kk // 2) - kk) // ss + 1 for d, kk, ss in zip(thw, k, s))
    e, thw = spec.embed_dim, spec.patch_dims
    total = 2 * batch * prod(thw) * e * spec.in_chans * prod(spec.patch_kernel)
    cls = int(spec.cls_embed_on)
    for b in spec.blocks:
        hd, n = b.head_dim, b.num_heads
        lq = prod(thw) + cls
        total += 2 * batch * lq * b.dim * 3 * b.dim
        thw_q = pool_out(thw, b, b.kernel_q, b.stride_q) if b.pool_q_on else thw
        thw_kv = pool_out(thw, b, b.kernel_kv, b.stride_kv) if b.pool_kv_on else thw
        if b.pool_q_on:
            total += 2 * batch * n * prod(thw_q) * hd * prod(b.kernel_q)
        if b.pool_kv_on:
            total += 2 * (2 * batch * n * prod(thw_kv) * hd * prod(b.kernel_kv))
        lq, lk = prod(thw_q) + cls, prod(thw_kv) + cls
        total += 2 * (2 * batch * n * lq * lk * hd)
        total += 2 * batch * lq * b.dim * b.dim
        total += 2 * batch * lq * (b.dim * b.hidden_dim + b.hidden_dim * b.dim_out)
        if b.dim != b.dim_out:
            total += 2 * batch * lq * b.dim * b.dim_out
        thw = thw_q
    return total + 2 * batch * spec.blocks[-1].dim_out * spec.num_classes


@pytest.mark.parametrize("cls", [True, False], ids=["cls", "no_cls"])
def test_flops_count_matches_an_analytic_count(cls):
    from test_torch_classifier import _small

    cfg = _small(get_cfg(), cls)
    model = build_model(cfg, device="cpu").eval()
    video = torch.randn(2, 8, 32, 32, 3)
    got = tmisc.flops_count(model, video)
    assert got == _classifier_flops(model.spec, 2)
    # a plain module too: one linear and one convolution
    lin, conv = torch.nn.Linear(6, 5), torch.nn.Conv2d(3, 4, 3)
    x = torch.randn(7, 6)
    img = torch.randn(2, 3, 9, 9)
    assert tmisc.flops_count(lambda: (lin(x), conv(img))) == 2 * 7 * 6 * 5 + 2 * 2 * 4 * 49 * 27


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Three synthetic clips, each listed four times in the train split."""
    root = str(tmp_path_factory.mktemp("loader"))
    prefix, splits = write_dataset(root, "ego4d", num_clips=3, res=(40, 56), seed=3)
    train_csv = os.path.join(splits, "train_ego4d_gaze.csv")
    with open(train_csv) as f:
        clips = f.read().splitlines()
    with open(train_csv, "w") as f:
        f.write("\n".join(clips * 4) + "\n")
    return prefix, splits


def _loader_cfg(split, workers: int):
    cfg = presets.small_cfg(2)
    cfg.DATA.PATH_PREFIX, cfg.DATA.PATH_TO_DATA_DIR = split
    cfg.DATA.DECODING_BACKEND = "npy"
    cfg.DATA.GAUSSIAN_KERNEL = 5
    cfg.DATA.TRAIN_JITTER_SCALES = [32, 40]
    cfg.DATA_LOADER.NUM_WORKERS = workers
    cfg.TEST.BATCH_SIZE = 4
    return cfg


@pytest.mark.parametrize("workers", [0, 2])
def test_benchmark_data_loading(split, workers):
    from csts_torch.data import loader as loader_lib

    before = set(procs.descendants())
    for num in (2, 100):
        cfg = _loader_cfg(split, workers)
        with loader_lib.construct_loader(cfg, "train") as loader:
            n = len(loader)
        stats = tmisc.benchmark_data_loading(cfg, num_batches=num)
        # the first batch is the warm-up; at most ``num`` batches are timed
        assert stats["batch_size"] == 2 and stats["batches"] == min(num, n - 1) > 0
        assert stats["clips_per_sec"] == pytest.approx(2 * stats["batches_per_sec"])
        assert stats["clips_per_sec"] > 0
    # the loaders' workers are gone when it returns
    now = procs.descendants()
    left = {p for p in now if p not in before and "forkserver" not in now[p][1]
            and "resource_tracker" not in now[p][1]}
    assert not left, left


def test_benchmark_loader_tool(split, tmp_path):
    """The tool reads a YAML written by the port's own writer."""
    cfg = _loader_cfg(split, 0)
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml_subset.dump(json.loads(json.dumps(cfg.dump()))))
    out = io.StringIO()
    with redirect_stdout(out):
        stats = benchmark_loader.main(["--cfg", str(path), "--batches", "1"])
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == stats
    assert stats["batches"] == 1


def test_bench_loader_scaling_tool(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        res = bench_loader_scaling.main(["--clips", "2", "--workers", "0", "1", "--batch", "2",
                                         "--epochs", "1", "--res", "40", "56",
                                         "--device-rate", "100.0"])
    assert [p["workers"] for p in res["curve"]] == [0, 1]
    assert all(p["clips_per_sec"] > 0 for p in res["curve"])
    assert res["cores_to_feed_device"] > 0
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == res
    root = out.getvalue().splitlines()[0].split(" under ")[-1]
    assert "csts_loader_scaling_" in root and not os.path.exists(root)  # removed after


# ----------------------------------------------------------------------------------
# the native loader ops
# ----------------------------------------------------------------------------------


def test_native_ops_build_from_the_port_source():
    so = nbuild.build()
    assert so.parent == nbuild.BUILD_DIR and so.parent.parent.name == "build"
    assert nbuild.SRC.parent.name == "native" and nbuild.SRC.parent.parent.name == "csts_torch"
    assert nbuild.get_lib().loader_ops_version() == nbuild.VERSION
    assert tnative.fused_crop_flip_normalize is not twins.fused_crop_flip_normalize


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "loader_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nbuild, "SRC", bad)
    monkeypatch.setattr(nbuild, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        nbuild.build()
    monkeypatch.setattr(nbuild, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.gaze_heatmaps(np.full((2, 3), 0.5, np.float32), 2, 8, 8, 5)
    monkeypatch.setattr(nbuild.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        nbuild.build()


def _gaze(rng, t=8):
    g = rng.uniform(0.0, 1.0, (t, 3))
    g[0, :2] = (0.5 / 16, 0.5 / 16)  # a half-pixel tie: banker's rounding
    g[1, :2] = (-0.4, 0.5)  # off the image: uniform
    g[2, :2] = (0.999, 0.001)  # clipped at two borders
    return g.astype(np.float32)


@pytest.mark.parametrize("hw,ksize", [((8, 8), 5), ((16, 16), 19), ((64, 64), 19),
                                      ((12, 20), 7), ((64, 80), 19)])
def test_native_heatmaps_bit_equal(hw, ksize):
    g = _gaze(np.random.default_rng(ksize + hw[1]))
    got = tnative.gaze_heatmaps(g, 8, *hw, ksize)
    assert jnative.available()
    np.testing.assert_array_equal(got, jnative.gaze_heatmaps(g, 8, *hw, ksize))
    np.testing.assert_array_equal(got, twins.gaze_heatmaps(g, 8, *hw, ksize))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("crop", [16, 32])
def test_native_crop_flip_normalize_bit_equal(dtype, flip, crop):
    rng = np.random.default_rng(crop)
    frames = rng.integers(0, 256, (3, 40, 56, 3)).astype(dtype)
    if dtype == np.float32:
        frames /= 255.0
    mean, std = [0.45, 0.4, 0.35], [0.225, 0.25, 0.2]
    got = tnative.fused_crop_flip_normalize(frames, 5, 9, crop, flip, mean, std)
    np.testing.assert_array_equal(
        got, jnative.fused_crop_flip_normalize(frames, 5, 9, crop, flip, mean, std))
    np.testing.assert_array_equal(
        got, twins.fused_crop_flip_normalize(frames, 5, 9, crop, flip, mean, std))
    with pytest.raises(IndexError):
        tnative.fused_crop_flip_normalize(frames, 30, 9, crop, flip, mean, std)
    with pytest.raises(TypeError):
        tnative.fused_crop_flip_normalize(frames.astype(np.float64), 0, 0, crop, flip, mean, std)
    with pytest.raises(ValueError):
        tnative.fused_crop_flip_normalize(frames[..., :2], 0, 0, crop, flip, mean, std)


def test_native_audio_slice_gather_bit_equal():
    audio = np.random.default_rng(2).standard_normal((32, 500)).astype(np.float32)
    centers = np.array([16, 40, 200, 484])
    got = tnative.audio_slice_gather(audio, centers, 16)
    np.testing.assert_array_equal(got, jnative.audio_slice_gather(audio, centers, 16))
    np.testing.assert_array_equal(got, twins.audio_slice_gather(audio, centers, 16))
    for bad in ([490], [15]):
        with pytest.raises(IndexError):
            tnative.audio_slice_gather(audio, np.array(bad), 16)


def test_dataset_runs_the_native_ops():
    from csts_torch.data import datasets, transform

    assert datasets.native is tnative and transform.native is tnative
    assert tnative.gaze_heatmaps.__module__ == "csts_torch.native.ops"


# ----------------------------------------------------------------------------------
# the Caffe2 converter
# ----------------------------------------------------------------------------------


def test_caffe2_names_match_jax():
    from test_convert_caffe2 import C2_NAMES

    for name in C2_NAMES:
        assert tc2.convert_c2_name(name) == jc2.convert_c2_name(name), name
    keys = {"s1.pathway0_stem.bn.split_bn.running_mean", "s1.pathway0_stem.bn.weight"}
    for key in ("s1.pathway0_stem.bn.running_mean", "s1.pathway0_stem.bn.weight",
                "s2.bn.running_var"):
        assert tc2.c2_key_to_sub_bn(key, keys) == jc2.c2_key_to_sub_bn(key, keys)


def test_caffe2_checkpoint_matches_jax(tmp_path):
    import pickle

    rng = np.random.default_rng(0)
    blobs = {
        "res2_0_branch1_w": rng.standard_normal((8, 4, 1, 1, 1)).astype(np.float32),
        "pred_w": rng.standard_normal((10, 8)).astype(np.float32),
        "pred_b": rng.standard_normal((10,)).astype(np.float32),
        "res_conv1_bn_rm": rng.standard_normal((4,)).astype(np.float32),
        "res_conv1_bn_riv": rng.random((4,)).astype(np.float32),
        "res_conv1_bn_s": rng.standard_normal((3,)).astype(np.float32),
        "conv1_w_momentum": rng.standard_normal((2,)).astype(np.float32),
        "model_iter": np.array([7]),
        "nonlocal_conv3_1_theta_w": rng.standard_normal((4, 4, 1, 1, 1)).astype(np.float32),
    }
    path = tmp_path / "c2.pkl"
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)
    shapes = {
        "s2.pathway0_res0.branch1.weight": (8, 4, 1, 1, 1),
        "head.projection.weight": (10, 8, 1, 1, 1),
        "head.projection.bias": (10,),
        "s1.pathway0_stem.bn.split_bn.running_mean": (8,),
        "s1.pathway0_stem.bn.running_var": (4,),
        "s1.pathway0_stem.bn.weight": (4,),
    }
    for model_shapes in (shapes, None):
        got = tc2.convert_caffe2_checkpoint(str(path), model_shapes)
        want = jc2.convert_caffe2_checkpoint(str(path), model_shapes)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(tc2.convert_caffe2_checkpoint(str(path), shapes)) == 5


# ----------------------------------------------------------------------------------
# the config printer and its YAML writer
# ----------------------------------------------------------------------------------


def _run_port_config(*args) -> str:
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "csts_torch.config", *args], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout


def _run_jax_config(*args) -> dict:
    out = io.StringIO()
    with redirect_stdout(out):
        assert jax_config_main(list(args)) == 0
    return yaml.safe_load(out.getvalue())


@pytest.mark.parametrize("args", [(), ("--cfg", SHIPPED, "TRAIN.BATCH_SIZE", "16"),
                                  ("--diff", "--cfg", SHIPPED, "TRAIN.BATCH_SIZE", "16"),
                                  ("--diff", "NUM_SHARDS", "4",
                                   "SOLVER.BASE_LR_SCALE_NUM_SHARDS", "True")],
                         ids=["defaults", "effective", "diff", "diff_finalize"])
def test_config_printer_reads_back_as_jax(args):
    text = _run_port_config(*args)
    got = yaml_subset.load(text)
    assert got == yaml.safe_load(text) == _run_jax_config(*args)


def test_config_printer_round_trips_through_load_config(tmp_path):
    path = tmp_path / "effective.yaml"
    path.write_text(_run_port_config("--cfg", SHIPPED, "SOLVER.BASE_LR", "1e-6"))
    cfg = load_config(str(path), output_dir=str(tmp_path))
    want = load_config(SHIPPED, ["SOLVER.BASE_LR", "1e-6"], output_dir=str(tmp_path))
    assert cfg.dump() == want.dump()
    assert cfg.dump() == jax_load_config(SHIPPED, ["SOLVER.BASE_LR", "1e-6"],
                                         output_dir=str(tmp_path)).dump()


@pytest.mark.parametrize("value", [
    "plain", "with space", "yes", "No", "null", "~", "", "1e-6", "0x1F", "12:30", "a: b",
    "# not a comment", "x #y", "[list]", "{map}", "it's", '"q"', "-", "- item", "&anchor",
    "2024-01-01", 0, -7, 3.5, 1e-6, 1e20, -2.5e-10, float("inf"), True, False, None,
    [], [1, [2.0, "s"]], ["a,b", "c]d", ""],
])
def test_yaml_writer_reads_back(value):
    text = yaml_subset.dump({"K": value, "S": {"NESTED": value}})
    want = {"K": value, "S": {"NESTED": value}}
    assert yaml_subset.load(text) == want
    assert yaml.safe_load(text) == want


def test_yaml_writer_refuses_what_has_no_form():
    for bad in ({"K": {}}, {"K": [{"a": 1}]}, {"K": "two\nlines"}, {"k y": 1}, {"K": object()}):
        with pytest.raises(yaml_subset.YamlSubsetError):
            yaml_subset.dump(bad)
    nan = yaml_subset.load(yaml_subset.dump({"K": float("nan")}))["K"]
    assert nan != nan


# ----------------------------------------------------------------------------------
# the log parser
# ----------------------------------------------------------------------------------


def test_plot_logs_csvs_match_jax(tmp_path):
    spec = importlib.util.spec_from_file_location("jax_plot_logs",
                                                  os.path.join(REPO, "tools", "plot_logs.py"))
    jplot = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jplot)
    lines = ["[12:00:00] starting", "not json_stats: {broken"]
    for e in (1, 2):
        for i in (1, 2, 3):
            lines.append("json_stats: " + json.dumps({"_type": "train_iter", "epoch": f"{e}/2",
                                                      "iter": f"{i}/3", "loss": 1.0 / (e * i),
                                                      "lr": 1e-4 * e}))
        lines.append("json_stats: " + json.dumps({"_type": "val_epoch", "epoch": f"{e}/2",
                                                  "f1": 0.3 * e, "extra": e}))
    lines.append("json_stats: " + json.dumps({"_type": "test_final", "f1": 0.7, "auc": 0.8}))
    log = tmp_path / "stdout.log"
    log.write_text("\n".join(lines) + "\n")
    out = io.StringIO()
    with redirect_stdout(out):
        assert plot_logs.main([str(log), "--out", str(tmp_path / "port")]) == 0
    assert 'test_final: {"_type": "test_final", "f1": 0.7, "auc": 0.8}' in out.getvalue()
    groups = jplot.parse_records(str(log))
    jplot.write_csvs(groups, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "test_final.csv", "train_iter.csv", "val_epoch.csv"]
    for name in names:
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    with open(tmp_path / "port" / "train_iter.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0][0] == "step" and [r[0] for r in rows[1:]] == [str(i) for i in range(6)]
    empty = tmp_path / "empty.log"
    empty.write_text("nothing\n")
    assert plot_logs.main([str(empty), "--out", str(tmp_path / "none")]) == 1

"""The port's checkpoint tools against the JAX package's, on the same files
(``csts_torch/tools/{inspect,average,convert,export}_checkpoint.py`` against
``tools/{inspect,average,convert,export}_checkpoint.py``), at ``small_cfg``:

* inspect: the same lines for an npz TrainState with and without ``--cfg``
  (names, dtypes, bytes, the params/optimizer split) and for a ``.pyth``;
  an orbax directory raises naming orbax.
* average: with ``--cfg`` the same archive as the JAX tool, leaf for leaf,
  to 0; without it the port takes P from the archive's layout and leaves
  the moments alone (the JAX tool averages them there); the EMA leaves are
  averaged where the archive has them.
* convert: ``.pyth`` (with an audio-branch ``.pyth``) → npz, leaf for leaf
  equal to the JAX tool's, which both packages load.
* export: npz → ``.pyth`` with the JAX tool's keys and values, and
  ``.pyth`` → npz → ``.pyth`` exact.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax

from csts_tpu.config import load_config as jax_load_config
from csts_tpu.models import csts as jcsts
from csts_tpu.utils import checkpoint as jcu
from csts_torch import presets
from csts_torch.models.csts import build_spec
from csts_torch.serving import GazePredictor
from csts_torch.tools import average_checkpoints, convert_checkpoint, export_checkpoint
from csts_torch.tools import inspect_checkpoint
from csts_torch.train import step as tstep
from csts_torch.utils import checkpoint as tcu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)

YAML = (
    "DATA:\n  TRAIN_CROP_SIZE: 32\n  TEST_CROP_SIZE: 32\n  AUDIO_FREQ_BINS: 32\n"
    "  AUDIO_WINDOW: 32\n"
    "MVIT:\n  DEPTH: 4\n  EMBED_DIM: 16\n  DROPPATH_RATE: 0.2\n  CLS_EMBED_ON: False\n"
    "  SEP_POS_EMBED: True\n  PATCH_PADDING: [1, 3, 3]\n  POOL_KVQ_KERNEL: [3, 3, 3]\n"
    "  POOL_KV_STRIDE_ADAPTIVE: [1, 8, 8]\n"
    "  DIM_MUL: [[1, 2.0], [2, 2.0], [3, 2.0]]\n  HEAD_MUL: [[1, 2.0], [2, 2.0], [3, 2.0]]\n"
    "  POOL_Q_STRIDE: [[1, 1, 2, 2], [2, 1, 2, 2], [3, 1, 2, 2]]\n"
    "MODEL:\n  LOSS_FUNC: kldiv+egonce\n"
)


def _jax_tool(name: str):
    """The JAX package's tool ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, "tools",
                                                                             f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _state(seed: int, ema: float = 0.0):
    """A port TrainState after one step from seeded weights (moments set)."""
    cfg = presets.small_cfg(2)
    cfg.SOLVER.EMA_DECAY = ema
    spec = build_spec(cfg)
    state = tstep.create_train_state(cfg, spec, torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    hm = rng.uniform(0.0, 1.0, (2, 8, 8, 8)).astype(np.float32)
    batch = {"video": torch.from_numpy(rng.standard_normal((2, 8, 32, 32, 3)).astype(np.float32)),
             "audio": torch.from_numpy(rng.standard_normal((2, 8, 32, 32, 1)).astype(np.float32)),
             "labels_hm": torch.from_numpy(hm / hm.sum(axis=(2, 3), keepdims=True))}
    tstep.make_train_step(cfg, spec, 10)(state, batch, torch.Generator().manual_seed(seed))
    return cfg, state


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The YAML, three TrainState npz without EMA and two with, a full
    ``.pyth`` and an audio MViT ``.pyth`` of the audio branch."""
    root = tmp_path_factory.mktemp("ckpt_tools")
    yaml_path = root / "cfg.yaml"
    yaml_path.write_text(YAML)
    out = {"root": root, "yaml": str(yaml_path), "plain": [], "ema": []}
    for i in range(3):
        cfg, state = _state(i)
        out["plain"].append(tcu.save_checkpoint(str(root / f"p{i}"), state, i, cfg))
    for i in range(2):
        cfg, state = _state(10 + i, ema=0.9)
        out["ema"].append(tcu.save_checkpoint(str(root / f"e{i}"), state, i, cfg))
    sd = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    out["pyth"] = str(root / "full.pyth")
    torch.save({"epoch": 3, "model_state": sd}, out["pyth"])
    audio = {}
    for k, v in sd.items():
        if k.startswith("blocks_audio."):
            audio["blocks." + k[len("blocks_audio."):]] = v * 0.5
        elif k.startswith("patch_embed_audio."):
            audio["patch_embed." + k[len("patch_embed_audio."):]] = v * 0.5
        elif k.startswith("pos_embed") and k.endswith("_audio"):
            audio[k[:-len("_audio")]] = v * 0.5
    out["audio"] = str(root / "audio.pyth")
    torch.save({"model_state": audio}, out["audio"])
    return out


def _leaves(path: str) -> dict:
    with np.load(path) as blob:
        return {k: blob[k] for k in blob.files}


@pytest.mark.parametrize("which", ["npz_cfg", "npz", "ema_cfg", "pyth"])
def test_inspect_prints_what_the_jax_tool_prints(files, which, capsys):
    jtool = _jax_tool("inspect_checkpoint")
    cfg = files["yaml"] if which.endswith("cfg") else None
    path = files["ema"][0] if which.startswith("ema") else files["plain"][0]
    runs = []
    for mod in (jtool, inspect_checkpoint):
        if which == "pyth":
            mod.inspect_pyth(files["pyth"], full=True)
        else:
            mod.inspect_npz(path, cfg_path=cfg, full=True)
        runs.append(capsys.readouterr().out)
    assert runs[1] == runs[0]
    if which == "npz_cfg":
        assert "decode_block4" in runs[1] and "[optimizer/EMA state]" in runs[1]
        assert "WARNING" not in runs[1]


def test_inspect_refuses_an_orbax_directory(tmp_path):
    with pytest.raises(NotImplementedError, match="orbax"):
        inspect_checkpoint.main([str(tmp_path)])


def test_average_matches_the_jax_tool(files, tmp_path, monkeypatch):
    """With ``--cfg``: the JAX tool's archive leaf for leaf (fp64 means cast
    back, so equal to 0). Without: the same archive (P from the layout),
    where the JAX tool also averages the moments and counts."""
    plain = files["plain"]
    jtool = _jax_tool("average_checkpoints")
    monkeypatch.setattr(sys, "argv", ["x", *plain, "--output", str(tmp_path / "jax.npz"),
                                      "--cfg", files["yaml"]])
    jtool.main()
    monkeypatch.setattr(sys, "argv", ["x", *plain, "--output", str(tmp_path / "jax_all.npz")])
    jtool.main()
    average_checkpoints.main([*plain, "--output", str(tmp_path / "cfg.npz"),
                              "--cfg", files["yaml"]])
    average_checkpoints.main([*plain, "--output", str(tmp_path / "layout.npz")])
    want = _leaves(str(tmp_path / "jax.npz"))
    p = len(inspect_checkpoint.param_names(files["yaml"]))
    assert len(want) == 3 * p + 4
    for name in ("cfg.npz", "layout.npz"):
        got = _leaves(str(tmp_path / name))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the JAX tool without --cfg averages the moments too; the port keeps the last's
    last, every = _leaves(plain[-1]), _leaves(str(tmp_path / "jax_all.npz"))
    moment = sorted(last)[p + 3]
    assert not np.array_equal(every[moment], last[moment])
    np.testing.assert_array_equal(_leaves(str(tmp_path / "layout.npz"))[moment], last[moment])
    assert tcu.checkpoint_meta(str(tmp_path / "layout.npz"))["averaged_from"] == [
        os.path.basename(q) for q in plain]


def test_average_takes_the_ema_leaves_too(files, tmp_path):
    """A 4P+4 archive: the params and the EMA's P leaves averaged, with or
    without ``--cfg``; the counts, lr and moments are the last input's."""
    ema = files["ema"]
    ins = [_leaves(q) for q in ema]
    keys = sorted(ins[0])
    p = len(inspect_checkpoint.param_names(files["yaml"]))
    assert len(keys) == 4 * p + 4
    for args in ([], ["--cfg", files["yaml"]]):
        out = str(tmp_path / f"soup{len(args)}.npz")
        average_checkpoints.main([*ema, "--output", out, *args])
        got = _leaves(out)
        for i, k in enumerate(keys):
            if i < p or i >= 3 * p + 4:
                want = ((ins[0][k].astype(np.float64) + ins[1][k]) / 2).astype(ins[1][k].dtype)
            else:
                want = ins[1][k]
            np.testing.assert_array_equal(got[k], want, err_msg=k)


def _convert(files, tmp_path, monkeypatch):
    jtool = _jax_tool("convert_checkpoint")
    args = ["--cfg", files["yaml"], "--input", files["pyth"], "--audio-checkpoint",
            files["audio"]]
    monkeypatch.setattr(sys, "argv", ["x", *args, "--output", str(tmp_path / "jax.npz")])
    monkeypatch.chdir(tmp_path)  # the JAX tool's config makes OUTPUT_DIR "." here
    jtool.main()
    convert_checkpoint.main([*args, "--output", str(tmp_path / "port.npz")])
    return str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")


def test_convert_matches_the_jax_tool(files, tmp_path, monkeypatch):
    """The audio branch from the audio ``.pyth`` (weights halved), the rest
    from the full one: leaf for leaf equal to the JAX tool's archive; the
    port's predictor and the JAX package's ``load_params_npz`` read it."""
    jpath, tpath = _convert(files, tmp_path, monkeypatch)
    want, got = _leaves(jpath), _leaves(tpath)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tcu.checkpoint_meta(tpath)["epoch"] == -1
    pred = GazePredictor.from_checkpoint(presets.small_cfg(1), tpath, device="cpu")
    sd = torch.load(files["pyth"], weights_only=True)["model_state"]
    named = dict(pred.model.named_parameters())
    torch.testing.assert_close(named["blocks.0.attn.qkv.weight"].float(),
                               sd["blocks.0.attn.qkv.weight"], rtol=0, atol=0)
    torch.testing.assert_close(named["blocks_audio.0.attn.qkv.weight"].float(),
                               sd["blocks_audio.0.attn.qkv.weight"] * 0.5, rtol=0, atol=0)
    jcfg = jax_load_config(files["yaml"], output_dir=str(tmp_path))
    params = jcsts.csts_init(jax.random.PRNGKey(5), jcsts.build_spec(jcfg))
    loaded = jcu.load_params_npz(tpath, params)
    np.testing.assert_array_equal(np.asarray(jax.tree_util.tree_leaves(loaded)[0]),
                                  want[sorted(want)[0]])


def test_export_matches_the_jax_tool_and_round_trips(files, tmp_path, monkeypatch):
    """npz → ``.pyth``: the JAX tool's keys, shapes and values, the
    sidecar's epoch; and the full ``.pyth`` through convert and export comes
    back exactly."""
    jtool = _jax_tool("export_checkpoint")
    npz = files["ema"][1]
    monkeypatch.setattr(sys, "argv", ["x", "--cfg", files["yaml"], "--input", npz,
                                      "--output", str(tmp_path / "jax.pyth")])
    monkeypatch.chdir(tmp_path)
    jtool.main()
    export_checkpoint.main(["--cfg", files["yaml"], "--input", npz,
                            "--output", str(tmp_path / "port.pyth")])
    want = torch.load(tmp_path / "jax.pyth", weights_only=True)
    got = torch.load(tmp_path / "port.pyth", weights_only=True)
    assert got["epoch"] == want["epoch"] == 1
    assert sorted(got["model_state"]) == sorted(want["model_state"])
    for k, v in want["model_state"].items():
        assert got["model_state"][k].dtype == v.dtype, k
        torch.testing.assert_close(got["model_state"][k], v, rtol=0, atol=0, msg=k)

    convert_checkpoint.main(["--cfg", files["yaml"], "--input", files["pyth"],
                             "--output", str(tmp_path / "trip.npz")])
    export_checkpoint.main(["--cfg", files["yaml"], "--input", str(tmp_path / "trip.npz"),
                            "--output", str(tmp_path / "trip.pyth"), "--epoch", "3"])
    start = torch.load(files["pyth"], weights_only=True)
    back = torch.load(tmp_path / "trip.pyth", weights_only=True)
    assert back["epoch"] == start["epoch"]
    assert sorted(back["model_state"]) == sorted(start["model_state"])
    for k, v in start["model_state"].items():
        torch.testing.assert_close(back["model_state"][k], v, rtol=0, atol=0, msg=k)

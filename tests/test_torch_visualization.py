"""The port's visualization (``csts_torch/eval/visualization.py``, numpy, no
cv2) against the JAX package's (``csts_tpu/eval/visualization.py``, cv2).

Bar: 1 uint8 level on every pixel. The port replays cv2's arithmetic
(INTER_LINEAR's fixed point, addWeighted's fused float32 products), and
against cv2 5.0 on an x86-64 CPU with FMA every array below comes out
equal; the level of slack covers a cv2 build that dispatches addWeighted
without FMA (it then rounds the product sums once more).
"""

from __future__ import annotations

import os

import cv2
import numpy as np
import pytest

from csts_torch.config import load_config
from csts_torch.data.synthetic import write_dataset
from csts_torch.eval import visualization as tvis
from csts_torch.models.csts import build_spec
from csts_torch.tools import visualize as tool
from csts_tpu.eval import visualization as jvis

BAR = 1


def _within(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8, what
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert int(d.max()) <= BAR, (what, int(d.max()), int((d > 0).sum()))


@pytest.mark.parametrize("src,dst", [((64, 64), (256, 256)), ((8, 8), (256, 256)),
                                     ((320, 400), (256, 256)), ((13, 17), (90, 100))])
def test_resizes_match_cv2(src, dst):
    rng = np.random.default_rng(src[0])
    gray = rng.integers(0, 256, src, dtype=np.uint8)
    rgb = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
    for img in (gray, rgb):
        _within(tvis.resize_linear(img, dst), cv2.resize(img, dst, interpolation=cv2.INTER_LINEAR),
                f"linear {img.shape}")
        _within(tvis.resize_nearest(img, dst),
                cv2.resize(img, dst, interpolation=cv2.INTER_NEAREST), f"nearest {img.shape}")


def test_colormaps_blend_circle_match_cv2():
    img = np.arange(256, dtype=np.uint8).reshape(16, 16)
    _within(tvis.apply_colormap(img, "jet"), cv2.applyColorMap(img, cv2.COLORMAP_JET), "jet")
    _within(tvis.apply_colormap(img, "viridis"), cv2.applyColorMap(img, cv2.COLORMAP_VIRIDIS),
            "viridis")
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 256, (40, 50, 3), dtype=np.uint8) for _ in range(2))
    for alpha in (0.5, 0.4, 0.3):
        _within(tvis.add_weighted(a, 1 - alpha, b, alpha),
                cv2.addWeighted(a, 1 - alpha, b, alpha, 0), f"addWeighted {alpha}")
    for center in ((10, 10), (0, 0), (49, 39), (-3, 20), (52, 7)):
        want = cv2.circle(a.copy(), center, 5, (0, 255, 0), -1)
        np.testing.assert_array_equal(tvis.circle(a.copy(), center, 5, (0, 255, 0)), want)
    _within(tvis.rgb_to_bgr(a), cv2.cvtColor(a, cv2.COLOR_RGB2BGR), "bgr")


def test_overlay_matches_jax():
    rng = np.random.default_rng(1)
    frame = rng.standard_normal((256, 256, 3)).astype(np.float32)
    u8 = jvis._to_uint8_frame(frame, (0.45,) * 3, (0.225,) * 3)
    _within(tvis._to_uint8_frame(frame, (0.45,) * 3, (0.225,) * 3), u8, "frame")
    for hm, alpha in ((rng.random((64, 64)).astype(np.float32), 0.5),
                      (rng.random((8, 8)).astype(np.float32), 0.4)):
        _within(tvis.heatmap_overlay(u8, hm, alpha), jvis.heatmap_overlay(u8, hm, alpha),
                f"overlay {hm.shape}")


def test_png_round_trip(tmp_path):
    """``read_png`` inverts ``write_png``, and cv2 decodes the files to the
    same arrays (BGR stored as RGB, as ``cv2.imwrite`` stores it)."""
    rng = np.random.default_rng(2)
    for img in (rng.integers(0, 256, (30, 41, 3), dtype=np.uint8),
                rng.integers(0, 256, (7, 5), dtype=np.uint8)):
        path = str(tmp_path / f"x{img.ndim}.png")
        tvis.write_png(path, img)
        np.testing.assert_array_equal(tvis.read_png(path), img)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    cv2.imwrite(str(tmp_path / "cv.png"), img)
    with pytest.raises(ValueError):  # cv2's rows take other filters
        tvis.read_png(str(tmp_path / "cv.png"))


def _jax_written(monkeypatch) -> dict:
    """What the JAX functions pass to cv2.imwrite, by file stem."""
    seen = {}
    monkeypatch.setattr(jvis.cv2, "imwrite", lambda path, img: seen.__setitem__(
        os.path.splitext(os.path.basename(path))[0], np.asarray(img).copy()) or True)
    return seen


def _port_written(root: str) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            assert n.endswith(".png"), n
            out[os.path.splitext(n)[0]] = tvis.read_png(os.path.join(dirpath, n))
    return out


def test_written_files_match_jax(tmp_path, monkeypatch):
    """Every vis_* function: the same file stems, each file's pixels within
    the bar of the array JAX writes."""
    rng = np.random.default_rng(3)
    t, (th, tw) = 8, (4, 8)
    video = rng.standard_normal((t, 64, 64, 3)).astype(np.float32)
    preds, labels_hm = rng.random((2, t, 16, 16)).astype(np.float32)
    thw = (4, 4, 4)
    length = thw[0] * thw[1] * thw[2] + thw[0]
    spatial = rng.random((2, length, length)).astype(np.float32)
    temporal = rng.random((3, th, th)).astype(np.float32)
    frames = rng.integers(0, 256, (40, 48, tw * 8, 3), dtype=np.uint8)
    idx = np.array([3, 8, 13, 18, 23, 28, 33, 38][:t])
    labels = np.concatenate([rng.uniform(0.1, 0.9, (t, 2)), np.zeros((t, 1))], 1)

    seen = _jax_written(monkeypatch)
    out = str(tmp_path / "port")
    for vis, root in ((jvis, str(tmp_path / "jax")), (tvis, out)):
        vis.vis_inference(root, video, preds, labels_hm)
        vis.vis_spatial_attention(root, video, spatial, thw)
        vis.vis_temporal_attention(root, temporal)
        vis.vis_video(root, frames, idx, preds, labels, prefix="v", size=64)
        vis.vis_video_forecasting(root, frames, idx[::-1], preds, None, prefix="f", size=48)
    got = _port_written(out)
    assert sorted(got) == sorted(seen)
    assert len(got) == t + 2 * thw[0] + 3 + 2 * (idx.max() - idx.min() + 1)
    for stem, want in seen.items():
        _within(got[stem], want, stem)


def test_visualize_tool_on_the_cpu(tmp_path):
    """``tools/visualize.py`` over a synthetic split with seeded weights: the
    overlays, the maps per head and frame, the temporal matrices, each a PNG
    of the expected size."""
    prefix, splits = write_dataset(str(tmp_path / "data"), "ego4d", num_clips=2, res=(32, 48),
                                   seed=4)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        "TRAIN:\n  ENABLE: False\n"
        f"DATA:\n  PATH_PREFIX: '{prefix}'\n  PATH_TO_DATA_DIR: '{splits}'\n"
        "  DECODING_BACKEND: npy\n  GAUSSIAN_KERNEL: 5\n"
        "  TRAIN_CROP_SIZE: 32\n  TEST_CROP_SIZE: 32\n  AUDIO_FREQ_BINS: 32\n  AUDIO_WINDOW: 32\n"
        "MVIT:\n  DEPTH: 4\n  EMBED_DIM: 16\n  CLS_EMBED_ON: False\n  SEP_POS_EMBED: True\n"
        "  PATCH_PADDING: [1, 3, 3]\n  POOL_KVQ_KERNEL: [3, 3, 3]\n"
        "  POOL_KV_STRIDE_ADAPTIVE: [1, 8, 8]\n"
        "  DIM_MUL: [[1, 2.0], [2, 2.0], [3, 2.0]]\n  HEAD_MUL: [[1, 2.0], [2, 2.0], [3, 2.0]]\n"
        "  POOL_Q_STRIDE: [[1, 1, 2, 2], [2, 1, 2, 2], [3, 1, 2, 2]]\n"
        "TEST:\n  BATCH_SIZE: 2\n  NUM_ENSEMBLE_VIEWS: 1\n  NUM_SPATIAL_CROPS: 1\n"
        "DATA_LOADER:\n  NUM_WORKERS: 0\n")
    out = tool.main(["--cfg", str(cfg), "--num-clips", "2", "--attention", "--device", "cpu",
                     "OUTPUT_DIR", str(tmp_path / "run")])
    spec = build_spec(load_config(str(cfg)))
    files = sorted(os.path.relpath(os.path.join(d, n), out)
                   for d, _, ns in os.walk(out) for n in ns)
    per_clip = (spec.num_frames + spec.spatial_fusion.num_heads * spec.fusion_thw[0]
                + spec.temporal_fusion.num_heads)
    assert len(files) == 2 * per_clip, files
    for f in files:
        img = tvis.read_png(os.path.join(out, f))
        if "temporal_attn" in f:
            assert img.shape == (256, 256, 3), f
        elif "spatial_attn" in f:
            assert img.shape == (32, 32, 3), f
        else:
            assert img.shape == (32, 64, 3), f

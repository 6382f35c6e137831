"""The port's data path against the JAX package on the CPU: sampling,
heatmaps, the loader ops (against ``csts_tpu.native``'s C++ build), the
resize (against cv2), the transforms, the STFT, every dataset variant's
items, the loader's batches and the device prefetcher.

Bars: index math, crops, heatmaps, audio slices and labels exact (the same
float32/float64 operations in the same order); the uint8 resize within one
level of cv2's (cv2 rounds through 11-bit fixed-point weights, PyTorch
through its own; the share of pixels that differ is asserted below 0.35:
0.230-0.267 at the four sizes below, printed with -s), the float32 resize
1e-4 (cv2's float path rounds its weights); the STFT in float64 1e-6 of ``stft_numpy`` and in
float32 1e-3 (the JAX package's bar for ``stft_jax``).
"""

import os

import cv2
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from csts_tpu import native as jnative
from csts_tpu.data import datasets as jds
from csts_tpu.data import heatmap as jheatmap
from csts_tpu.data import loader as jloader
from csts_tpu.data import sampling as jsampling
from csts_tpu.data import stft as jstft
from csts_tpu.data import transform as jtransform
from csts_tpu.data import video as jvideo
from csts_torch import native as tnative
from csts_torch import presets
from csts_torch.data import datasets as tds
from csts_torch.data import heatmap as theatmap
from csts_torch.data import loader as tloader
from csts_torch.data import sampling as tsampling
from csts_torch.data import stft as tstft
from csts_torch.data import transform as ttransform
from csts_torch.data import video as tvideo
from csts_torch.data.synthetic import write_dataset

torch.set_num_threads(2)

CROP = 32


# ------------------------------------------------------------------ sampling


@pytest.mark.parametrize("clip_idx,num_clips,offset", [
    (-1, 1, False), (0, 1, False), (1, 1, False), (0, 3, True), (2, 3, True), (1, 1, True),
    (3, 10, False)])
def test_sampling_windows(clip_idx, num_clips, offset):
    for video_size, clip_size in [(150, 64.0), (86, 64.0), (30, 64.0), (100, 42.666)]:
        got = tsampling.get_start_end_idx(video_size, clip_size, clip_idx, num_clips, offset,
                                          np.random.default_rng(7))
        want = jsampling.get_start_end_idx(video_size, clip_size, clip_idx, num_clips, offset,
                                           np.random.default_rng(7))
        assert got == want
        np.testing.assert_array_equal(tsampling.temporal_sampling_indices(*got, 8, video_size - 1),
                                      jsampling.temporal_sampling_indices(*want, 8, video_size - 1))
    assert (tsampling.clip_size_frames(8, 8, 30, 25.0)
            == jsampling.clip_size_frames(8, 8, 30, 25.0))


@pytest.mark.parametrize("train", [False, True])
def test_forecast_and_audio_indices(train):
    np.testing.assert_array_equal(tsampling.forecast_label_indices(70, 86, 150, 8, train),
                                  jsampling.forecast_label_indices(70, 86, 150, 8, train))
    frames = np.array([0, 9, 18, 27, 36, 45, 54, 63]) + (10 if train else 0)
    for stft_len, half in [(1000, 128), (600, 16), (300, 128)]:
        got = tsampling.audio_slice_indices(frames, 86, stft_len, half)
        np.testing.assert_array_equal(got, jsampling.audio_slice_indices(frames, 86, stft_len, half))
    audio = np.random.default_rng(0).standard_normal((8, 600)).astype(np.float32)
    idx = tsampling.audio_slice_indices(frames, 86, 600, 16)
    np.testing.assert_array_equal(tsampling.slice_audio_frames(audio, idx, 16),
                                  jsampling.slice_audio_frames(audio, idx, 16))


# ------------------------------------------------------------------ heatmaps and loader ops


@pytest.mark.parametrize("ksize", [1, 3, 5, 7, 9, 19])
def test_gaussian_kernel(ksize):
    got = theatmap.gaussian_kernel_1d(ksize)
    np.testing.assert_array_equal(got, jheatmap.gaussian_kernel_1d(ksize))
    if ksize != 9:  # cv2 keeps a fixed-point table at 9, which neither package copies
        np.testing.assert_allclose(got, cv2.getGaussianKernel(ksize, -1, cv2.CV_32F), atol=1e-7)


def _gaze(rng, t=8):
    g = rng.uniform(0.0, 1.0, (t, 3))
    g[0, :2] = (0.5 / 16, 0.5 / 16)  # a half-pixel tie: banker's rounding
    g[1, :2] = (-0.4, 0.5)  # off the image: uniform
    g[2, :2] = (0.999, 0.001)  # clipped at two borders
    return g.astype(np.float32)


@pytest.mark.parametrize("hw,ksize", [((8, 8), 5), ((16, 16), 19), ((64, 64), 19), ((12, 20), 7)])
def test_gaze_heatmaps(hw, ksize):
    rng = np.random.default_rng(ksize)
    g = _gaze(rng)
    got = tnative.gaze_heatmaps(g, 8, *hw, ksize)
    assert jnative.available()  # the JAX package's C++ ops, built by g++
    np.testing.assert_array_equal(got, jnative.gaze_heatmaps(g, 8, *hw, ksize))
    # the numpy version sums in another order
    np.testing.assert_allclose(got, jheatmap.gaze_heatmaps(g, 8, *hw, ksize), atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(got.sum(axis=(1, 2)), 1.0, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("flip", [False, True])
def test_fused_crop_flip_normalize(dtype, flip):
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (4, 40, 56, 3)).astype(dtype)
    if dtype == np.float32:
        frames /= 255.0
    mean, std = [0.45, 0.4, 0.35], [0.225, 0.25, 0.2]
    got = tnative.fused_crop_flip_normalize(frames, 3, 11, CROP, flip, mean, std)
    np.testing.assert_array_equal(
        got, jnative.fused_crop_flip_normalize(frames, 3, 11, CROP, flip, mean, std))


def test_audio_slice_gather():
    audio = np.random.default_rng(2).standard_normal((32, 500)).astype(np.float32)
    centers = np.array([16, 40, 200, 483])
    np.testing.assert_array_equal(tnative.audio_slice_gather(audio, centers, 16),
                                  jnative.audio_slice_gather(audio, centers, 16))
    with pytest.raises(IndexError):
        tnative.audio_slice_gather(audio, np.array([490]), 16)


# ------------------------------------------------------------------ transforms


@pytest.mark.parametrize("hw,size", [((40, 56), 32), ((300, 400), 256), ((256, 340), 224),
                                     ((56, 40), 32)])
def test_resize_against_cv2(hw, size):
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    got = ttransform.short_side_scale(frames, size)
    want = jtransform.short_side_scale(frames, size)  # cv2.resize INTER_LINEAR
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"resize {hw} -> {size}: {(diff > 0).mean():.3f} of uint8 pixels differ from cv2 "
          f"by {diff.max()} level")
    assert diff.max() <= 1 and (diff > 0).mean() < 0.35, (diff.max(), (diff > 0).mean())
    f32 = frames.astype(np.float32) / 255.0
    np.testing.assert_allclose(ttransform.short_side_scale(f32, size),
                               jtransform.short_side_scale(f32, size), atol=1e-4)
    assert ttransform.short_side_scale(got, size) is got  # already at size


def test_crops_and_flip():
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (8, 40, 56, 3), dtype=np.uint8)
    gaze = rng.uniform(0.2, 0.8, (8, 3)).astype(np.float32)
    for idx in (0, 1, 2):
        got, want = (m.uniform_crop_gaze(frames, CROP, idx, gaze) for m in (ttransform, jtransform))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    got, want = (m.random_crop_gaze(frames, CROP, gaze, np.random.default_rng(5))
                 + m.horizontal_flip_gaze(frames, gaze, np.random.default_rng(1), prob=1.0)
                 for m in (ttransform, jtransform))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # the loader op's normalisation (1/255 and 1/std multiplied in float32)
    # against the JAX package's divisions
    np.testing.assert_allclose(
        tnative.fused_crop_flip_normalize(frames, 0, 0, CROP, False, [0.45] * 3, [0.225] * 3),
        jtransform.tensor_normalize(frames[:, :CROP, :CROP], [0.45] * 3, [0.225] * 3),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("spatial_idx", [-1, 0, 1, 2])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("hw", [(32, 48), (40, 56)])
def test_spatial_sampling(spatial_idx, normalize, hw):
    """The port's one sampling path against the JAX package's fused path and,
    on uint8 without normalisation, its dispatcher ``spatial_sampling_gaze``:
    the same numbers drawn from the same generator. At short side 32 = crop
    nothing resizes and the outputs are equal; at 40x56 the resize rounds
    within one level."""
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (8, *hw, 3), dtype=np.uint8)
    gaze = rng.uniform(0.2, 0.8, (8, 3)).astype(np.float32)
    scales = (32, 40) if spatial_idx == -1 else (32, 32)
    kw = dict(spatial_idx=spatial_idx, min_scale=scales[0], max_scale=scales[1], crop_size=CROP,
              random_horizontal_flip=True, mean=[0.45] * 3, std=[0.225] * 3, normalize=normalize)
    got = ttransform.spatial_sampling_fused(frames, gaze, rng=np.random.default_rng(8), **kw)
    want = jtransform.spatial_sampling_fused(frames, gaze, rng=np.random.default_rng(8), **kw)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype
    one_level = 1 if got[0].dtype == np.uint8 else 1 / 255 / 0.225 + 1e-5
    tol = 0 if min(hw) == CROP and spatial_idx != -1 else one_level
    np.testing.assert_allclose(got[0].astype(np.float32), want[0].astype(np.float32), atol=tol,
                               rtol=0)
    if normalize:
        return
    got = ttransform.spatial_sampling_fused(frames, gaze, rng=np.random.default_rng(8), **kw)
    kw.pop("normalize"), kw.pop("mean"), kw.pop("std")
    want = jtransform.spatial_sampling_gaze(frames, gaze, rng=np.random.default_rng(8), **kw)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0].astype(np.int16), want[0].astype(np.int16),
                               atol=0 if tol == 0 else 1)


# ------------------------------------------------------------------ stft


def test_stft_torch():
    samples = np.random.default_rng(9).standard_normal(24000).astype(np.float32)
    ref = tstft.stft_numpy(samples, 24000)
    np.testing.assert_array_equal(ref, jstft.stft_numpy(samples, 24000))
    got64 = tstft.stft_torch(torch.from_numpy(samples).double(), 24000)
    assert got64.shape == ref.shape == (256, 200)
    np.testing.assert_allclose(got64.numpy(), ref, atol=1e-6, rtol=0)
    got32 = tstft.stft_torch(torch.from_numpy(samples), 24000).numpy()
    np.testing.assert_allclose(got32, ref, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got32, np.asarray(jstft.stft_jax(samples, 24000)), atol=1e-3, rtol=0)


# ------------------------------------------------------------------ datasets


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Ego4D and Aria layouts at a source short side of 32 (= the crop: the
    test transform does not resize) and of 40 (the train jitter and the
    40x56 sources resize)."""
    out = {}
    for layout, fps, frames in (("ego4d", 30, 150), ("aria", 20, 100)):
        for res in ((32, 48), (40, 56)):
            root = str(tmp_path_factory.mktemp(f"{layout}{res[0]}"))
            out[layout, res[0]] = (root, *write_dataset(root, layout, num_clips=3, frames=frames,
                                                        res=res, fps=fps, seed=res[0]))
    return out


def _cfgs(prefix, splits, layout, out_dir):
    """The same settings on a JAX config and on the port's."""
    pair = graft._small_cfg(4), presets.small_cfg(4)
    for c in pair:
        c.DATA.PATH_PREFIX, c.DATA.PATH_TO_DATA_DIR = prefix, splits
        c.DATA.DECODING_BACKEND = "npy"
        c.DATA.GAUSSIAN_KERNEL = 5
        c.DATA.TRAIN_JITTER_SCALES = [36, 40]
        if layout == "aria":
            c.DATA.SAMPLING_RATE, c.DATA.TARGET_FPS = 4, 20
        c.TEST.NUM_ENSEMBLE_VIEWS = 1
        c.TEST.NUM_SPATIAL_CROPS = 1
        c.TEST.BATCH_SIZE = 2
        c.TRAIN.BATCH_SIZE = 2
        c.DATA_LOADER.NUM_WORKERS = 0
        c.OUTPUT_DIR = out_dir
    return pair


def _assert_items_equal(got, want, video_atol=0):
    assert set(got) == set(want)
    for key in ("audio", "labels", "labels_hm"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["video"].dtype == want["video"].dtype and got["video"].shape == want["video"].shape
    np.testing.assert_allclose(got["video"].astype(np.float32), want["video"].astype(np.float32),
                               atol=video_atol, rtol=0)
    assert got["index"] == want["index"]
    assert got["meta"]["path"] == want["meta"]["path"]
    for key in ("index", "labels_index"):
        np.testing.assert_array_equal(got["meta"][key], want["meta"][key])


@pytest.mark.parametrize("variant", ["ego4d_av_gaze", "ego4d_av_gaze_forecast", "aria_av_gaze",
                                     "aria_av_gaze_forecast"])
@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("uint8", [True, False])
def test_getitem_matches(roots, tmp_path, variant, mode, uint8):
    layout = variant.split("_")[0]
    res = 40 if mode == "train" else 32
    root, prefix, splits = roots[layout, res]
    jcfg, tcfg = _cfgs(prefix, splits, layout, str(tmp_path))
    for c in (jcfg, tcfg):
        c.DATA_LOADER.UINT8_TRANSFER = uint8
    jset, tset = jds.build_dataset(variant, jcfg, mode), tds.build_dataset(variant, tcfg, mode)
    assert len(tset) == len(jset) == 3
    # the train jitter resizes: uint8 within one level, float one level normalised
    atol = 0 if mode == "test" else (1 if uint8 else 1 / 255 / 0.225 + 1e-5)
    for i in range(len(tset)):
        _assert_items_equal(tset.__getitem__(i, rng=np.random.default_rng(i)),
                            jset.__getitem__(i, rng=np.random.default_rng(i)), atol)


def test_full_frame_items_match(roots, tmp_path):
    root, prefix, splits = roots["ego4d", 32]
    jcfg, tcfg = _cfgs(prefix, splits, "ego4d", str(tmp_path))
    for c in (jcfg, tcfg):
        c.TEST.FULL_FRAME_TEST = True
    jset = jds.build_dataset("ego4d_av_gaze", jcfg, "test")
    tset = tds.build_dataset("ego4d_av_gaze", tcfg, "test")
    assert len(tset) == len(jset) > 3
    for i in (0, 7, len(tset) - 1):
        _assert_items_equal(tset.__getitem__(i, rng=np.random.default_rng(0)),
                            jset.__getitem__(i, rng=np.random.default_rng(0)))


def test_video_readers(roots):
    root, prefix, _ = roots["ego4d", 32]
    path = os.path.join(prefix, "vid001", "clip01_t5_t10.mp4")
    assert tvideo.sidecar_num_frames(path) == jvideo.sidecar_num_frames(path) == 150
    assert "npy" in tvideo.available_backends()
    got, want = tvideo.open_clip(path), jvideo.open_clip(path)
    assert vars(got.meta()) == vars(want.meta())
    for a, b in zip(got.read_window(140, 160), want.read_window(140, 160)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError):
        tvideo.open_clip(path, "opencv")


def test_aug_in_training_raises(roots, tmp_path):
    root, prefix, splits = roots["ego4d", 32]
    _, tcfg = _cfgs(prefix, splits, "ego4d", str(tmp_path))
    tcfg.AUG.ENABLE = True
    with pytest.raises(NotImplementedError, match="A.6"):
        tds.build_dataset("ego4d_av_gaze_forecast", tcfg, "train")
    tds.build_dataset("ego4d_av_gaze_forecast", tcfg, "test")  # eval reads no AUG


# ------------------------------------------------------------------ loader


def _jax_batches(jcfg, split):
    name = jcfg.TEST.DATASET if split == "test" else jcfg.TRAIN.DATASET
    train = split == "train"
    bsz = jcfg.TRAIN.BATCH_SIZE if train else jcfg.TEST.BATCH_SIZE
    loader = jloader.GazeLoader(jds.build_dataset(name, jcfg, split), bsz, shuffle=train,
                                num_workers=2, seed=jcfg.RNG_SEED, drop_last=train)
    loader.set_epoch(1)
    return list(loader)


@pytest.mark.parametrize("split,workers", [("test", 0), ("train", 0), ("test", 2)])
def test_loader_batches_match(roots, tmp_path, split, workers):
    """The port's batches against the JAX loader's: the same rows in the same
    order with the same draws. The JAX test split wrap-pads its final batch
    (3 rows at batch 2: [2, 0]); the port's stays short ([2]), and a meter
    reading the JAX batches drops the repeated row."""
    root, prefix, splits = roots["ego4d", 40]
    jcfg, tcfg = _cfgs(prefix, splits, "ego4d", str(tmp_path))
    for c in (jcfg, tcfg):
        c.TRAIN.DATASET = c.TEST.DATASET = "ego4d_av_gaze_forecast"
    tcfg.DATA_LOADER.NUM_WORKERS = workers
    loader = tloader.construct_loader(tcfg, split, torch.device("cpu"))
    loader.set_epoch(1)
    got = list(loader)
    want = _jax_batches(jcfg, split)
    assert len(got) == len(loader) == len(want) == (1 if split == "train" else 2)
    seen = set()
    for g, w in zip(got, want):
        fresh = np.array([int(i) not in seen for i in w["index"]])
        seen.update(int(i) for i in w["index"])
        np.testing.assert_array_equal(g["index"].numpy(), w["index"][fresh])
        assert g["video"].dtype == torch.uint8 and g["audio"].dtype == torch.float16
        for key in tloader.BATCH_KEYS:
            tol = 1 if key == "video" else 0  # the 40x56 sources resize
            np.testing.assert_allclose(g[key].float().numpy(), w[key][fresh].astype(np.float32),
                                       atol=tol, rtol=0, err_msg=key)
    if split == "test":
        assert sorted(int(i) for b in got for i in b["index"]) == [0, 1, 2]


def test_loader_resume_and_epoch_order(roots, tmp_path):
    root, prefix, splits = roots["ego4d", 40]
    _, tcfg = _cfgs(prefix, splits, "ego4d", str(tmp_path))
    tcfg.TRAIN.BATCH_SIZE = 1
    tcfg.TRAIN.DATASET = "ego4d_av_gaze_forecast"
    loader = tloader.construct_loader(tcfg, "train", torch.device("cpu"))
    loader.set_epoch(2)
    full = list(loader)
    loader.set_epoch(2, start_iter=1)
    tail = list(loader)
    assert len(full) == 3 and len(tail) == 2
    for a, b in zip(full[1:], tail):
        for key in ("index", *tloader.BATCH_KEYS):
            assert torch.equal(a[key], b[key])
    loader.set_epoch(3)
    other = list(loader)
    assert any(not torch.equal(a["video"], b["video"]) for a, b in zip(full, other))


def test_prefetcher_raises_decode_error_in_consumer(roots, tmp_path):
    """A clip that cannot be read fails the epoch in the consumer, after the
    batches before it."""
    root, prefix, splits = roots["ego4d", 32]
    _, tcfg = _cfgs(prefix, splits, "ego4d", str(tmp_path))
    tcfg.TEST.DATASET = "ego4d_av_gaze_forecast"
    tcfg.TEST.BATCH_SIZE = 1
    loader = tloader.construct_loader(tcfg, "test", torch.device("cpu"))
    bad = loader.dataset.dataset._path_to_videos[2] + ".frames.npy"
    os.rename(bad, bad + ".hidden")
    try:
        got = []
        with tloader.DevicePrefetcher(iter(loader), torch.device("cpu"), depth=2) as prefetch:
            with pytest.raises(RuntimeError, match="Failed to fetch"):
                for batch in prefetch:
                    got.append(int(batch["index"][0]))
            with pytest.raises(RuntimeError, match="Failed to fetch"):
                next(prefetch)  # and on every later call
        assert got == [0, 1]
    finally:
        os.rename(bad + ".hidden", bad)


def test_prefetcher_close_mid_epoch(roots, tmp_path):
    root, prefix, splits = roots["ego4d", 32]
    _, tcfg = _cfgs(prefix, splits, "ego4d", str(tmp_path))
    tcfg.TEST.DATASET = "ego4d_av_gaze_forecast"
    tcfg.TEST.BATCH_SIZE = 1
    loader = tloader.construct_loader(tcfg, "test", torch.device("cpu"))
    prefetch = tloader.DevicePrefetcher(iter(loader), torch.device("cpu"), depth=1)
    first = next(prefetch)
    prefetch.close()
    assert int(first["index"][0]) == 0 and not prefetch._thread.is_alive()


def test_dataset_pickles_as_its_arguments(roots, tmp_path):
    """A loader worker receives the dataset's arguments (a few KB, inside a
    pipe's buffer) and rebuilds the index, which gives the same items."""
    import pickle

    root, prefix, splits = roots["ego4d", 32]
    _, tcfg = _cfgs(prefix, splits, "ego4d", str(tmp_path))
    tset = tds.build_dataset("ego4d_av_gaze_forecast", tcfg, "test")
    blob = pickle.dumps(tloader.SeededItems(tset, 3))
    assert len(blob) < 16384
    again = pickle.loads(blob)
    assert len(again) == len(tset) and again.seed == 3
    _assert_items_equal(again.dataset.__getitem__(1, rng=np.random.default_rng(0)),
                        tset.__getitem__(1, rng=np.random.default_rng(0)))

"""The offline preprocessing CLI (``csts_torch/data/preprocess.py``) against
``csts_tpu.data.preprocess`` on the same inputs: the counterparts of
``tests/test_preprocess.py``, each compared with the JAX module's output,
and ``pack``'s resize over a stubbed reader (this sandbox has no container
decoder the port may use, and no ffmpeg binary)."""

import json
import os
import wave

import numpy as np
import pytest

from csts_torch.data import preprocess as tp
from csts_tpu.data import preprocess as jp


def test_ego4d_trim_windows():
    for dur, untracked in ((17.0, None), (17.0, [(4, 6)]), (31.5, [(12, 12), (20, 24)])):
        got = list(tp.ego4d_trim_windows(dur, untracked))
        assert got == list(jp.ego4d_trim_windows(dur, untracked))
    assert [(a, b) for a, b, _ in tp.ego4d_trim_windows(17.0, [(4, 6)])] == [(10, 15)]


def test_aria_trim_windows():
    for dur in (4.0, 10.0, 23.7):
        assert list(tp.aria_trim_windows(dur)) == list(jp.aria_trim_windows(dur))
    assert list(tp.aria_trim_windows(10.0))[0][2] == "t0_t4"


def test_parse_untracked_csv(tmp_path):
    p = tmp_path / "untracked.csv"
    p.write_text("vid1,0:00:05,0:00:12,360\nvid1,0:01:00,0:01:30,900\nvid2,1:00:00,1:00:10,30\n")
    assert tp.parse_untracked_csv(str(p)) == jp.parse_untracked_csv(str(p))
    assert tp.parse_untracked_csv(str(p))["vid1"] == [(5, 12), (60, 90)]


def test_ego4d_frame_labels():
    ts = np.arange(0, 1.0, 0.1)
    xy = np.stack([np.linspace(0.4, 0.6, 10), np.full(10, 0.5)], axis=1)
    xy[5] = [3.0, 0.5]  # off the image
    rng = np.random.default_rng(3)
    xy2 = rng.random((10, 2))
    for args, kw in (((ts, xy, 30, 30), {}), ((ts, xy, 30, 30), {"untracked": [(0.0, 0.2)]}),
                     ((ts, xy2, 45, 30), {"saccade_px": 100.0, "res_h": 720.0})):
        got = tp.ego4d_frame_labels(*args, **kw)
        np.testing.assert_array_equal(got, jp.ego4d_frame_labels(*args, **kw))
    assert (tp.ego4d_frame_labels(ts, xy, 30, 30)[:, 2] == tp.GAZE_TRIMMED).any()


def test_aria_frame_labels(tmp_path):
    ts = np.arange(0, 1.0, 0.1)
    xy_px = np.stack([np.linspace(200, 900, 10), np.linspace(200, 400, 10)], axis=1)
    got = tp.aria_frame_labels(ts, xy_px, num_frames=20, fps=20)
    np.testing.assert_array_equal(got, jp.aria_frame_labels(ts, xy_px, num_frames=20, fps=20))
    assert (got[1:, 2] == tp.GAZE_SACCADE).any()
    tp.write_frame_label_csv(str(tmp_path / "a.csv"), got)
    jp.write_frame_label_csv(str(tmp_path / "b.csv"), got)
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()


def test_parse_clip_window():
    for name in ("vid_t10_t15.mp4", "movie_123_t4_t8.mp4", "noclip.mp4", "a_tx_t5.mp4",
                 "v/clip_t0_t5"):
        assert tp.parse_clip_window(name) == jp.parse_clip_window(name)
    assert tp.parse_clip_window("movie_123_t4_t8.mp4") == (4, 9)


def test_splits_stage(tmp_path):
    """scan_clip_tree, make_splits (pinned and seeded) and the CLI's CSVs
    equal JAX's on one clip tree."""
    clips = tmp_path / "clips.gaze"
    for vid, starts in (("vidA", [0, 5, 10]), ("vidB", [0, 5]), ("vidC", [0]), ("vidD", [5])):
        (clips / vid).mkdir(parents=True)
        for s in starts:
            (clips / vid / f"{vid}_t{s}_t{s+5}.mp4").write_bytes(b"")
    (clips / "vidA" / "vidA_t15_t20.mp4.frames.npy").write_bytes(b"")
    skip_name = sorted(tp.EGO4D_SKIP_VIDEOS)[0][:-4]
    (clips / skip_name).mkdir()
    (clips / skip_name / f"{skip_name}_t0_t5.mp4").write_bytes(b"")

    videos = tp.scan_clip_tree(str(clips))
    assert videos == jp.scan_clip_tree(str(clips))
    untracked = {"vidA": [(4, 6)]}
    kw = dict(test_videos={"vidB"}, untracked=untracked, skip_videos=tp.EGO4D_SKIP_VIDEOS)
    got = tp.make_splits(videos, **kw)
    assert got == jp.make_splits(videos, **kw)
    assert got[0] == ["vidA/vidA_t10_t15.mp4", "vidA/vidA_t15_t20.mp4", "vidC/vidC_t0_t5.mp4",
                      "vidD/vidD_t5_t10.mp4"]
    for seed in (7, 42):
        assert tp.make_splits(videos, test_fraction=0.34, seed=seed) == \
            jp.make_splits(videos, test_fraction=0.34, seed=seed)

    (tmp_path / "untracked.csv").write_text("vidA,0:00:04,0:00:06,60\n")
    outs = {}
    for name, mod in (("torch", tp), ("jax", jp)):
        out = tmp_path / f"splits_{name}"
        assert mod.main(["splits", "--clips", str(clips), "--output", str(out), "--dataset",
                         "ego4d", "--untracked-csv", str(tmp_path / "untracked.csv")]) == 0
        outs[name] = {f: (out / f).read_text() for f in sorted(os.listdir(out))}
    assert outs["torch"] == outs["jax"] and len(outs["torch"]) == 3


def _write_wav(path, samples, sr=24000, width=2, channels=1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(samples.tobytes())


def test_wav_roundtrip_stft(tmp_path):
    """load_wav (16-bit mono, 32-bit stereo) and the wav -> STFT file equal
    JAX's bit for bit; the 440 Hz tone peaks in its bin."""
    sr = 24000
    t = np.arange(sr) / sr
    tone = (0.5 * np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int16)
    _write_wav(tmp_path / "tone.wav", tone)
    rng = np.random.default_rng(0)
    _write_wav(tmp_path / "st.wav", rng.integers(-2**30, 2**30, (4000, 2)).astype(np.int32),
               width=4, channels=2)
    for name in ("tone.wav", "st.wav"):
        a, sra = tp.load_wav(str(tmp_path / name))
        b, srb = jp.load_wav(str(tmp_path / name))
        assert sra == srb
        np.testing.assert_array_equal(a, b)
    tp.audio_stft_file(str(tmp_path / "tone.wav"), str(tmp_path / "t.npy"))
    jp.audio_stft_file(str(tmp_path / "tone.wav"), str(tmp_path / "j.npy"))
    spec = np.load(tmp_path / "t.npy")
    np.testing.assert_array_equal(spec, np.load(tmp_path / "j.npy"))
    assert spec.shape[0] == 256 and 8 <= np.argmax(spec.mean(axis=1)) <= 11


def test_stft_stage_parallel_workers(tmp_path):
    """The stft stage serially and with 2 spawned workers writes JAX's files."""
    sr = 24000
    wav_dir = tmp_path / "wavs"
    (wav_dir / "v").mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        _write_wav(wav_dir / "v" / f"c{i}.wav",
                   (0.3 * rng.standard_normal(sr // 2) * 32767).astype(np.int16))
    assert tp.main(["stft", "--input", str(wav_dir), "--output", str(tmp_path / "s")]) == 0
    assert tp.main(["stft", "--input", str(wav_dir), "--output", str(tmp_path / "p"),
                    "--workers", "2"]) == 0
    assert jp.main(["stft", "--input", str(wav_dir), "--output", str(tmp_path / "j")]) == 0
    for i in range(3):
        ref = np.load(tmp_path / "j" / "v" / f"c{i}.npy")
        np.testing.assert_array_equal(np.load(tmp_path / "s" / "v" / f"c{i}.npy"), ref)
        np.testing.assert_array_equal(np.load(tmp_path / "p" / "v" / f"c{i}.npy"), ref)


def test_check_stage(tmp_path):
    """check over the JAX tests' synthetic Ego4D and Aria trees: the same
    report as JAX's, clean and after damage, and the same exit codes."""
    from test_end_to_end import make_aria_synthetic, make_synthetic_dataset

    root = str(tmp_path / "ego")
    os.makedirs(root)
    prefix = make_synthetic_dataset(root)
    splits = os.path.join(root, "splits")
    ds = "ego4d_av_gaze_forecast"
    report = tp.check_data_tree(prefix, splits, ds)
    assert report == jp.check_data_tree(prefix, splits, ds)
    assert report["problems"] == [] and report["clips"] == 8
    args = ["check", "--prefix", prefix, "--data-dir", splits, "--dataset", ds]
    assert tp.main(args) == 0
    # a label file too short for the clips at TARGET_FPS 60
    assert tp.check_data_tree(prefix, splits, ds, target_fps=60) == \
        jp.check_data_tree(prefix, splits, ds, target_fps=60)
    os.remove(os.path.join(prefix, "vid001", "clip00_t0_t5.mp4.frames.npy"))
    os.remove(os.path.join(root, "clips.gaze.audio_stft", "vid001", "clip01_t5_t10.npy"))
    os.remove(os.path.join(root, "gaze_frame_label", "vid001_frame_label.csv"))
    report = tp.check_data_tree(prefix, splits, ds)
    assert report == jp.check_data_tree(prefix, splits, ds)
    text = "\n".join(report["problems"])
    assert "no video container or packed" in text and "missing gaze label file" in text
    assert tp.main(args) == 1 and jp.main(args) == 1

    aroot = str(tmp_path / "aria")
    os.makedirs(aroot)
    make_aria_synthetic(aroot)
    a = (os.path.join(aroot, "clips"), os.path.join(aroot, "splits"), "aria_av_gaze_forecast")
    report = tp.check_data_tree(*a)
    assert report == jp.check_data_tree(*a) and report["problems"] == []


class _StubReader:
    def __init__(self, frames, fps=30.0):
        self.frames, self.fps = frames, fps

    def meta(self):
        from csts_torch.data.video import ClipMeta

        return ClipMeta(fps=self.fps, num_frames=self.frames.shape[0],
                        duration_pts=self.frames.shape[0] * 512)

    def read_window(self, a, b):
        return self.frames[a:b + 1].copy(), np.arange(a, b + 1)

    def close(self):
        pass


@pytest.mark.parametrize("shape,short", [((5, 48, 80, 3), 32), ((4, 90, 50, 3), 36),
                                         ((3, 30, 40, 3), 32), ((3, 40, 60, 3), 0)])
def test_pack_resize_over_stub_reader(tmp_path, monkeypatch, shape, short):
    """pack_clip over a stubbed reader: the port's frames (``resize_linear``)
    within one uint8 level of JAX's (cv2's INTER_LINEAR), the same shapes and
    the same meta.json; a clip already at or under the short side is kept."""
    from csts_torch.data import video as tvideo
    from csts_tpu.data import video as jvideo

    frames = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    monkeypatch.setattr(tvideo, "open_clip", lambda *a, **k: _StubReader(frames))
    monkeypatch.setattr(jvideo, "open_clip", lambda *a, **k: _StubReader(frames))
    outs = {}
    for name, mod in (("t", tp), ("j", jp)):
        src = tmp_path / name / "v" / "c_t0_t5.mp4"
        src.parent.mkdir(parents=True)
        assert mod.pack_clip(str(src), short or None) == str(src) + ".frames.npy"
        outs[name] = (np.load(str(src) + ".frames.npy"),
                      json.loads(open(str(src) + ".meta.json").read()))
    (a, ma), (b, mb) = outs["t"], outs["j"]
    assert a.shape == b.shape and a.dtype == np.uint8 and ma == mb
    assert int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()) <= 1
    if not short or min(shape[1:3]) <= short:
        np.testing.assert_array_equal(a, frames)


def test_trim_and_audio_need_ffmpeg(tmp_path, monkeypatch):
    """Without an ffmpeg binary ``trim_video`` and ``extract_audio`` raise
    RuntimeError, as JAX's do."""
    import shutil

    monkeypatch.setattr(shutil, "which", lambda name: None)
    for mod in (tp, jp):
        with pytest.raises(RuntimeError, match="ffmpeg"):
            mod.trim_video(str(tmp_path / "x.mp4"), str(tmp_path / "o"), [(0, 5, "t0_t5")])
        with pytest.raises(RuntimeError, match="ffmpeg"):
            mod.extract_audio(str(tmp_path / "x.mp4"), str(tmp_path / "x.wav"))

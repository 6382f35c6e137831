"""AV-gaze clip datasets: {Ego4D, Aria} × {estimation, forecast}, the port's
copy of ``csts_tpu/data/datasets.py``.

ONE parameterized dataset + four registry entries (the reference's four
near-copy classes ``ego4d_avgaze.py``, ``ego4d_avgaze_forecast.py``,
``aria_avgaze.py``, ``aria_avgaze_forecast.py``). Differences between
variants are data, not code:

=====================  ==========================  =========================
                       Ego4D                       Aria
=====================  ==========================  =========================
audio path rule        clips.gaze → .audio_stft    clips → clips.audio_24kHz_stft
label file             <vid>_frame_label.csv       <vid>.csv
label columns          [:, 1:]                     [:, 2:]
observed (forecast)    86 of 150 @30fps            60 of 100 @20fps
forecast label gap     0                           SAMPLING_RATE (1 s protocol gap)
=====================  ==========================  =========================

Every random choice threads an explicit ``np.random.Generator`` (per-sample
seeded by the loader). Items are numpy arrays; the loader collates them into
tensors. AUG.ENABLE (RandAugment and random erasing in training) is not
ported yet and raises.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from csts_torch import native
from csts_torch.config import Config
from csts_torch.data import sampling, transform, video
from csts_torch.utils.registry import Registry

DATASET_REGISTRY = Registry("DATASET")


@dataclass(frozen=True)
class VariantSpec:
    name: str
    train_csv: str
    test_csv: str
    audio_rule: tuple  # (src_fragment, dst_fragment)
    label_suffix: str
    label_col_offset: int
    forecast: bool
    observed_frames: Optional[int]  # None => estimation (observe everything)
    forecast_label_gap_in_sampling_rate: bool  # Aria skips SAMPLING_RATE frames

    # Path-derivation rules (the JAX package's `preprocess check` validator
    # reads the same ones, so the two cannot diverge on what the loader reads).
    def audio_path(self, video_path: str) -> str:
        src, dst = self.audio_rule
        return video_path.replace(src, dst).replace(".mp4", ".npy")

    def video_name(self, video_path: str) -> str:
        return video_path.split("/")[-2]

    def label_path(self, root: str, video_name: str) -> str:
        return os.path.join(root, "gaze_frame_label", video_name + self.label_suffix)


_VARIANTS = {
    "ego4d_av_gaze": VariantSpec(
        "ego4d_av_gaze", "train_ego4d_gaze.csv", "test_ego4d_gaze.csv",
        ("clips.gaze", "clips.gaze.audio_stft"), "_frame_label.csv", 1,
        forecast=False, observed_frames=None, forecast_label_gap_in_sampling_rate=False,
    ),
    "ego4d_av_gaze_forecast": VariantSpec(
        "ego4d_av_gaze_forecast", "train_ego4d_gaze.csv", "test_ego4d_gaze.csv",
        ("clips.gaze", "clips.gaze.audio_stft"), "_frame_label.csv", 1,
        forecast=True, observed_frames=86, forecast_label_gap_in_sampling_rate=False,
    ),
    "aria_av_gaze": VariantSpec(
        "aria_av_gaze", "train_aria_gaze.csv", "test_aria_gaze.csv",
        ("clips", "clips.audio_24kHz_stft"), ".csv", 2,
        forecast=False, observed_frames=None, forecast_label_gap_in_sampling_rate=False,
    ),
    "aria_av_gaze_forecast": VariantSpec(
        "aria_av_gaze_forecast", "train_aria_gaze.csv", "test_aria_gaze.csv",
        ("clips", "clips.audio_24kHz_stft"), ".csv", 2,
        forecast=True, observed_frames=60, forecast_label_gap_in_sampling_rate=True,
    ),
}

AUDIO_HALF_WINDOW = 128  # STFT columns per side → 256-wide audio slice per frame


class AVGazeDataset:
    """One clip per item; multi-view test expansion via NUM_ENSEMBLE_VIEWS ×
    NUM_SPATIAL_CROPS (reference __init__:64-67)."""

    def __init__(self, cfg: Config, mode: str, variant: VariantSpec, num_retries: int = 10):
        assert mode in ("train", "val", "test"), mode
        if mode == "train" and cfg.AUG.ENABLE:
            raise NotImplementedError(
                "AUG.ENABLE (RandAugment, random erasing) is not ported yet (ROADMAP A.6)")
        self.cfg = cfg
        self.mode = mode
        self.variant = variant
        self._num_retries = num_retries
        self._num_clips = (
            1 if mode in ("train", "val")
            else cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
        )
        self._construct()

    def __getstate__(self):
        """What a loader worker receives: the arguments, not the built state.
        A process start writes its pickled arguments to a pipe; beyond the
        pipe's buffer the parent waits until the new worker has imported its
        modules, worker after worker (the label tables alone pass the buffer
        on a small split). Each worker rebuilds the index from the files."""
        return {"cfg": self.cfg, "mode": self.mode, "variant": self.variant,
                "num_retries": self._num_retries}

    def __setstate__(self, state):
        self.__init__(state["cfg"], state["mode"], state["variant"], state["num_retries"])

    # ------------------------------------------------------------------ build
    def _construct(self):
        data_dir = self.cfg.DATA.PATH_TO_DATA_DIR or "data"
        csv_name = self.variant.train_csv if self.mode == "train" else self.variant.test_csv
        path_to_file = os.path.join(data_dir, csv_name)
        assert os.path.exists(path_to_file), f"{path_to_file} not found"

        self._path_to_videos = []
        self._spatial_temporal_idx = []
        with open(path_to_file) as f:
            for path in f.read().splitlines():
                if not path:
                    continue
                for idx in range(self._num_clips):
                    self._path_to_videos.append(os.path.join(self.cfg.DATA.PATH_PREFIX, path))
                    self._spatial_temporal_idx.append(idx)
        assert self._path_to_videos, f"empty split {path_to_file}"

        self._path_to_audios = [
            self.variant.audio_path(p) for p in self._path_to_videos
        ]

        # per-video gaze labels, loaded once into RAM (reference :108-122)
        self._labels: Dict[str, np.ndarray] = {}
        prefix = os.path.dirname(self.cfg.DATA.PATH_PREFIX)
        for p in self._path_to_videos:
            video_name = self.variant.video_name(p)
            if video_name in self._labels:
                continue
            label_path = self.variant.label_path(prefix, video_name)
            with open(label_path) as f:
                rows = [list(map(float, row)) for i, row in enumerate(csv.reader(f)) if i > 0]
            self._labels[video_name] = np.asarray(rows)[:, self.variant.label_col_offset:]

        # Per-frame sliding-window eval (TEST.FULL_FRAME_TEST): every frame of every
        # clip becomes the anchor of one 8-frame window at stride SAMPLING_RATE+1.
        # The reference sketches this for the estimation datasets but its config key
        # was never defined (ego4d_avgaze.py:118-131 — latent AttributeError); this
        # is the working version.
        self._full_frame_inputs = []
        self._num_frames_cache: Dict[str, int] = {}
        if (
            self.cfg.TEST.FULL_FRAME_TEST
            and not self.variant.forecast
            and self.mode in ("val", "test")
        ):
            stride = self.cfg.DATA.SAMPLING_RATE + 1
            nf = self.cfg.DATA.NUM_FRAMES
            for path in dict.fromkeys(self._path_to_videos):  # unique, ordered
                frames_length = self._probe_num_frames(path)
                start_idx = 0
                while start_idx < frames_length:
                    last = start_idx
                    for i in range(start_idx, min(start_idx + stride, frames_length)):
                        idx = [min(i + j * stride, frames_length - 1) for j in range(nf)]
                        self._full_frame_inputs.append((path, np.asarray(idx)))
                        last = idx[-1]
                    start_idx = last + 1

    def _backend(self) -> str:
        """DATA.DECODING_BACKEND, or "auto" where it names pyav and PyAV is absent."""
        backend = self.cfg.DATA.DECODING_BACKEND
        if backend == "pyav" and "pyav" not in video.available_backends():
            return "auto"
        return backend

    def _probe_num_frames(self, path: str) -> int:
        """Frame count of one clip, with zero-decode fast paths.

        Sliding-window construction probes every unique video; opening a decoder
        container per video is O(videos) decode opens before the first item. The
        ``pack`` stage's meta.json records ``num_frames`` and the npy header
        carries the shape, so the packed tree probes from metadata only — a real
        container open is the last resort."""
        cached = self._num_frames_cache.get(path)
        if cached is not None:
            return cached
        n = video.sidecar_num_frames(path)
        if not n:
            reader = video.open_clip(path, self._backend(), target_fps=self.cfg.DATA.TARGET_FPS)
            n = reader.meta().num_frames
            reader.close()
        self._num_frames_cache[path] = n
        return n

    def __len__(self):
        if self._full_frame_inputs:
            return len(self._full_frame_inputs)
        return len(self._path_to_videos)

    num_videos = property(__len__)

    # ------------------------------------------------------------------ fetch
    def _sampling_params(self, index: int, rng: np.random.Generator):
        if self.mode == "train":
            return dict(
                temporal_idx=-1,
                spatial_idx=-1,
                min_scale=self.cfg.DATA.TRAIN_JITTER_SCALES[0],
                max_scale=self.cfg.DATA.TRAIN_JITTER_SCALES[1],
                crop_size=self.cfg.DATA.TRAIN_CROP_SIZE,
            )
        # val/test: deterministic window, center crop (reference :186-203). With
        # NUM_ENSEMBLE_VIEWS > 1 the temporal view index spreads windows across the
        # clip (reference: spatial_temporal_idx // NUM_SPATIAL_CROPS); single-view
        # keeps the right-most window.
        spatial_idx = (
            self._spatial_temporal_idx[index] % self.cfg.TEST.NUM_SPATIAL_CROPS
            if self.cfg.TEST.NUM_SPATIAL_CROPS > 1
            else 1
        )
        temporal_idx = (
            self._spatial_temporal_idx[index] // self.cfg.TEST.NUM_SPATIAL_CROPS
            if self.cfg.TEST.NUM_ENSEMBLE_VIEWS > 1
            else 1
        )
        size = self.cfg.DATA.TEST_CROP_SIZE
        return dict(
            temporal_idx=temporal_idx, spatial_idx=spatial_idx,
            min_scale=size, max_scale=size, crop_size=size,
        )

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None):
        if rng is None:
            rng = np.random.default_rng()
        if self._full_frame_inputs:
            return self._getitem_full_frame(index, rng)
        params = self._sampling_params(index, rng)
        num_frames = self.cfg.DATA.NUM_FRAMES
        sampling_rate = self.cfg.DATA.SAMPLING_RATE
        target_fps = self.cfg.DATA.TARGET_FPS

        for i_try in range(self._num_retries):
            try:
                reader = video.open_clip(self._path_to_videos[index], self._backend(),
                                         target_fps=target_fps)
            except Exception:
                if self.mode != "test" and i_try > self._num_retries // 2:
                    index = int(rng.integers(0, len(self)))
                continue

            meta = reader.meta()
            ori_frame_length = meta.num_frames
            frame_length = self.variant.observed_frames or ori_frame_length

            # --- observed-window decode (decoder.py pyav path semantics)
            clip_size = sampling.clip_size_frames(sampling_rate, num_frames, target_fps, meta.fps)
            start_f, end_f = sampling.get_start_end_idx(
                frame_length, clip_size, params["temporal_idx"],
                self.cfg.TEST.NUM_ENSEMBLE_VIEWS, self.cfg.DATA.USE_OFFSET_SAMPLING, rng,
            )
            # pts truncation parity: frame window = pts in [int(start·tb), int(end·tb)]
            tb = (meta.duration_pts / ori_frame_length) if meta.duration_pts else 1.0
            start_pts, end_pts = int(start_f * tb), int(end_f * tb)
            win_start = int(np.ceil(start_pts / tb - 1e-9))
            win_end = int(np.floor(end_pts / tb + 1e-9))
            frames_win, idx_win = reader.read_window(win_start, win_end)
            reader.close()
            if frames_win.shape[0] == 0:
                if self.mode != "test" and i_try > self._num_retries // 2:
                    index = int(rng.integers(0, len(self)))
                continue

            s2, e2 = sampling.get_start_end_idx(frames_win.shape[0], clip_size, 0, 1)
            sel = sampling.temporal_sampling_indices(s2, e2, num_frames, frames_win.shape[0] - 1)
            frames = frames_win[sel]
            frames_idx = idx_win[sel]

            # --- audio slices aligned to the sampled frames
            audio = np.load(self._path_to_audios[index])
            audio = audio[: self.cfg.DATA.AUDIO_FREQ_BINS]
            if self.variant.forecast:
                audio = audio[:, : int(audio.shape[1] * frame_length / ori_frame_length)]
            half_window = self.cfg.DATA.AUDIO_WINDOW // 2
            audio_idx = sampling.audio_slice_indices(
                frames_idx, frame_length, audio.shape[1], half_window
            )
            audio_frames = native.audio_slice_gather(
                np.ascontiguousarray(audio, np.float32), audio_idx, half_window
            )

            # --- label frame indices (observed for estimation, future for forecast)
            video_path = self._path_to_videos[index]
            video_name, clip_name = video_path.split("/")[-2:]
            tstart, tend = clip_name[:-4].split("_")[-2:]
            clip_fstart = int(tstart[1:]) * target_fps
            frames_global_idx = frames_idx + clip_fstart

            if self.variant.forecast:
                gap = sampling_rate if self.variant.forecast_label_gap_in_sampling_rate else 0
                if self.mode == "train":
                    last = int(frames_idx[-1])
                    arange = np.arange(last + 1 + gap, last + 1 + ori_frame_length - frame_length)
                else:
                    arange = np.arange(frame_length + gap, ori_frame_length)
                labels_idx = np.linspace(arange[0], arange[-1], num_frames).astype(np.int64)
                labels_global = labels_idx + clip_fstart
            else:
                labels_global = frames_global_idx

            vlabels = self._labels[video_name]
            if self.mode != "test" and labels_global[-1] >= vlabels.shape[0]:
                index = int(rng.integers(0, len(self)))
                continue
            labels_global = np.clip(labels_global, 0, vlabels.shape[0] - 1)
            label = vlabels[labels_global, :].astype(np.float32)

            # --- normalize + gaze-aware spatial transform (one fused pass).
            # With UINT8_TRANSFER the frames stay uint8 and the /255+mean/std affine
            # moves into the forward (CSTS.forward) — 4× less h2d per clip.
            want_uint8 = self.cfg.DATA_LOADER.UINT8_TRANSFER and frames.dtype == np.uint8
            frames, label = transform.spatial_sampling_fused(
                frames, label,
                spatial_idx=params["spatial_idx"],
                min_scale=params["min_scale"], max_scale=params["max_scale"],
                crop_size=params["crop_size"],
                random_horizontal_flip=self.cfg.DATA.RANDOM_FLIP,
                rng=rng,
                mean=self.cfg.DATA.MEAN, std=self.cfg.DATA.STD,
                normalize=not want_uint8,
            )

            # --- label heatmaps at crop/4 (reference :318-328)
            hm_size = params["crop_size"] // 4
            label_hm = native.gaze_heatmaps(
                label, num_frames, hm_size, hm_size, self.cfg.DATA.GAUSSIAN_KERNEL
            )

            return {
                "video": frames if frames.dtype == np.uint8 else frames.astype(np.float32),
                "audio": audio_frames.astype(
                    np.float16 if self.cfg.DATA_LOADER.UINT8_TRANSFER else np.float32
                )[..., None],
                "labels": label,
                "labels_hm": label_hm,
                "index": index,
                "meta": {
                    "path": video_path,
                    "index": frames_global_idx,
                    "labels_index": labels_global,
                },
            }
        raise RuntimeError(f"Failed to fetch video after {self._num_retries} retries.")

    def _getitem_full_frame(self, index: int, rng: np.random.Generator):
        """Sliding-window item (ego4d_avgaze.py:278-332 semantics, working version)."""
        video_path, frames_idx = self._full_frame_inputs[index]
        reader = video.open_clip(video_path, self._backend(), target_fps=self.cfg.DATA.TARGET_FPS)
        meta = reader.meta()
        frame_length = meta.num_frames
        window, idx_win = reader.read_window(int(frames_idx.min()), int(frames_idx.max()))
        reader.close()
        pos = np.searchsorted(idx_win, frames_idx)
        frames = window[np.clip(pos, 0, len(idx_win) - 1)]

        audio = np.load(self._path_to_audios_for(video_path))
        audio = audio[: self.cfg.DATA.AUDIO_FREQ_BINS]
        half_window = self.cfg.DATA.AUDIO_WINDOW // 2
        audio_idx = sampling.audio_slice_indices(frames_idx, frame_length, audio.shape[1], half_window)
        audio_frames = native.audio_slice_gather(
            np.ascontiguousarray(audio, np.float32), audio_idx, half_window
        )

        video_name, clip_name = video_path.split("/")[-2:]
        tstart = int(clip_name[:-4].split("_")[-2][1:])
        clip_fstart = tstart * self.cfg.DATA.TARGET_FPS
        frames_global_idx = frames_idx + clip_fstart
        vlabels = self._labels[video_name]
        labels_global = np.clip(frames_global_idx, 0, vlabels.shape[0] - 1)
        label = vlabels[labels_global, :].astype(np.float32)

        size = self.cfg.DATA.TEST_CROP_SIZE
        want_uint8 = self.cfg.DATA_LOADER.UINT8_TRANSFER and frames.dtype == np.uint8
        frames, label = transform.spatial_sampling_fused(
            frames, label, spatial_idx=1, min_scale=size, max_scale=size,
            crop_size=size, random_horizontal_flip=False, rng=rng,
            mean=self.cfg.DATA.MEAN, std=self.cfg.DATA.STD,
            normalize=not want_uint8,
        )
        hm_size = size // 4
        label_hm = native.gaze_heatmaps(
            label, self.cfg.DATA.NUM_FRAMES, hm_size, hm_size, self.cfg.DATA.GAUSSIAN_KERNEL
        )
        return {
            "video": frames if frames.dtype == np.uint8 else frames.astype(np.float32),
            "audio": audio_frames.astype(
                np.float16 if self.cfg.DATA_LOADER.UINT8_TRANSFER else np.float32
            )[..., None],
            "labels": label,
            "labels_hm": label_hm,
            "index": index,
            "meta": {"path": video_path, "index": frames_global_idx,
                     "labels_index": labels_global},
        }

    def _path_to_audios_for(self, video_path: str) -> str:
        return self.variant.audio_path(video_path)


def _register(name):
    def construct(cfg, mode, **kw):
        return AVGazeDataset(cfg, mode, _VARIANTS[name], **kw)

    construct.__name__ = name
    DATASET_REGISTRY.register(name, construct)


for _name in _VARIANTS:
    _register(_name)


def build_dataset(dataset_name: str, cfg: Config, split: str) -> AVGazeDataset:
    """(reference build.py:15-31)"""
    return DATASET_REGISTRY.get(dataset_name)(cfg, split)

"""Temporal sampling math, the port's copy of ``csts_tpu/data/sampling.py``
(reference: ``slowfast/datasets/decoder.py:12-68,396-411``).

Backend-independent: these index computations are the parity-critical part of decoding
(SURVEY §7 hard-part 2 — an off-by-one here silently shifts labels and audio slices).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def clip_size_frames(sampling_rate: int, num_frames: int, target_fps: float, fps: float) -> float:
    """The reference's modified clip-size formula guaranteeing uniform spacing
    (decoder.py:285,397): ((rate+1)·(frames−1)+1) / target_fps · fps."""
    return ((sampling_rate + 1) * (num_frames - 1) + 1) / target_fps * fps


def get_start_end_idx(
    video_size: float,
    clip_size: float,
    clip_idx: int,
    num_clips: int,
    use_offset: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[float, float]:
    """(decoder.py:32-68). clip_idx == -1 → random window (needs ``rng``)."""
    delta = max(video_size - clip_size, 0)
    if clip_idx == -1:
        assert rng is not None, "random temporal sampling needs an rng"
        start_idx = rng.uniform(0, delta)
    else:
        if use_offset:
            if num_clips == 1:
                start_idx = float(np.floor(delta / 2))
            else:
                start_idx = clip_idx * float(np.floor(delta / (num_clips - 1)))
        else:
            start_idx = delta * clip_idx / num_clips
    end_idx = start_idx + clip_size - 1
    return start_idx, end_idx


def temporal_sampling_indices(start_idx: float, end_idx: float, num_samples: int, max_idx: int) -> np.ndarray:
    """linspace(start, end, n) clamped — torch.linspace().clamp().long() parity
    (decoder.py:12-29). torch.linspace then .long() truncates toward zero."""
    index = np.linspace(start_idx, end_idx, num_samples)
    index = np.clip(index, 0, max_idx)
    return index.astype(np.int64)


def forecast_label_indices(
    observed_last_idx: int,
    observed_length: int,
    total_length: int,
    num_frames: int,
    train: bool,
) -> np.ndarray:
    """Future-label frame indices for gaze forecasting
    (ego4d_avgaze_forecast.py:230-235): train → the ``total−observed`` frames after
    the last observed index; test → frames [observed_length, total_length), both
    linspace-subsampled to ``num_frames``."""
    if train:
        labels_idx = np.arange(
            observed_last_idx + 1, observed_last_idx + 1 + total_length - observed_length
        )
    else:
        labels_idx = np.arange(observed_length, total_length)
    return np.linspace(labels_idx[0], labels_idx[-1], num_frames).astype(np.int64)


def audio_slice_indices(
    frames_idx: np.ndarray, frame_length: int, stft_len: int, half_window: int = 128
) -> np.ndarray:
    """Per-frame STFT column index, clipped so the ±half_window slice stays in range
    (ego4d_avgaze.py:249-255 / ego4d_avgaze_forecast.py:216-218)."""
    audio_idx = (frames_idx / frame_length) * stft_len
    audio_idx = np.round(audio_idx).astype(np.int64)
    return np.clip(audio_idx, half_window, stft_len - 1 - half_window)


def slice_audio_frames(audio: np.ndarray, audio_idx: np.ndarray, half_window: int = 128) -> np.ndarray:
    """Gather (F, 2·half_window) slices per frame → (T, F, 2·half_window)."""
    return np.stack([audio[:, i - half_window : i + half_window] for i in audio_idx], axis=0)

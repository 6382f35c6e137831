"""numpy-facing wrappers over the native loader ops (``csts_tpu/native/ops.py``).

Each takes and returns numpy arrays, checks its arguments as its numpy twin
(``csts_torch/native/twins.py``) does, and runs the C++ loop of
``loader_ops.cpp``. There is no fallback: a library that does not build
raises (``build.get_lib``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from csts_torch.data.heatmap import gaussian_kernel_1d
from csts_torch.native.build import get_lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def fused_crop_flip_normalize(
    frames: np.ndarray, y0: int, x0: int, crop: int, flip: bool, mean, std,
) -> np.ndarray:
    """uint8/float32 (T, H, W, 3) -> float32 (T, crop, crop, 3):
    ``(frame / 255 - mean) / std`` over the crop window (uint8; float32
    frames skip the /255), mirrored in x when ``flip``; one pass."""
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (T, H, W, 3) frames, got {frames.shape}")
    if frames.dtype not in (np.uint8, np.float32):
        raise TypeError(f"frames must be uint8 or float32, got {frames.dtype}")
    t, h, w, _ = frames.shape
    if y0 < 0 or x0 < 0 or y0 + crop > h or x0 + crop > w:
        raise IndexError(f"crop {crop} at ({y0}, {x0}) outside {h}x{w} frames")
    lib = get_lib()
    mean_arr = np.ascontiguousarray(mean, np.float32)
    inv_std = (np.float32(1.0) / np.asarray(std, np.float32)).astype(np.float32)
    frames = np.ascontiguousarray(frames)
    out = np.empty((t, crop, crop, 3), np.float32)
    if frames.dtype == np.uint8:
        lib.fused_crop_flip_normalize(
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            t, h, w, y0, x0, crop, int(flip), _fp(mean_arr), _fp(inv_std), _fp(out))
    else:
        lib.fused_crop_flip_normalize_f32(
            _fp(frames), t, h, w, y0, x0, crop, int(flip), _fp(mean_arr), _fp(inv_std), 0,
            _fp(out))
    return out


def audio_slice_gather(audio: np.ndarray, centers: np.ndarray, half: int) -> np.ndarray:
    """float32 (F, L) + (T,) centers -> (T, F, 2·half)."""
    centers = np.ascontiguousarray(centers, np.int64)
    if centers.size and (centers.min() < half or centers.max() + half > audio.shape[1]):
        raise IndexError(f"audio slices {centers.min()}..{centers.max()} ±{half} "
                         f"outside {audio.shape[1]} columns")
    lib = get_lib()
    audio = np.ascontiguousarray(audio, np.float32)
    f_bins, length = audio.shape
    out = np.empty((len(centers), f_bins, 2 * half), np.float32)
    lib.audio_slice_gather(_fp(audio), f_bins, length,
                           centers.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                           len(centers), half, _fp(out))
    return out


def gaze_heatmaps(
    gaze_loc: np.ndarray, num_frames: int, height: int, width: int, kernel_size: int
) -> np.ndarray:
    """Per-frame label heatmaps (T, H, W): the Gaussian stamp of
    ``kernel_size`` at each frame's gaze point, clipped at the borders and
    normalised to sum 1; uniform where the stamp misses the image."""
    lib = get_lib()
    k1 = gaussian_kernel_1d(kernel_size, -1.0)
    k2 = np.ascontiguousarray(k1 * k1.T, np.float32)
    gaze = np.ascontiguousarray(gaze_loc[:num_frames, :2], np.float64)
    out = np.empty((num_frames, height, width), np.float32)
    lib.gaze_heatmaps(gaze.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                      num_frames, _fp(k2), kernel_size, height, width, _fp(out))
    return out

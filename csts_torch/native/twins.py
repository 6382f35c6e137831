"""numpy twins of the C++ loader ops (``csts_torch/native/loader_ops.cpp``,
the loops of ``csts_tpu/native/loader_ops.cpp``).

Each follows the C++ loop's arithmetic, not the JAX package's numpy
fallback, so the twin, the port's native op and the JAX package's give the
same bits: the normalisation multiplies by 1/255 and by 1/std in float32,
and a heatmap's stamp is summed in float64 in row order and scaled by the
float32 reciprocal of that sum. The dataset runs the native ops; the twins
are what the tests hold them against.
"""

from __future__ import annotations

import numpy as np

from csts_torch.data.heatmap import gaussian_kernel_1d


def fused_crop_flip_normalize(
    frames: np.ndarray, y0: int, x0: int, crop: int, flip: bool, mean, std,
) -> np.ndarray:
    """uint8/float32 (T, H, W, 3) -> float32 (T, crop, crop, 3):
    ``(frame / 255 - mean) / std`` over the crop window (uint8; float32
    frames skip the /255), mirrored in x when ``flip``."""
    if frames.shape[-1] != 3:
        raise ValueError(f"expected (T, H, W, 3) frames, got {frames.shape}")
    mean = np.asarray(mean, np.float32)
    inv_std = (np.float32(1.0) / np.asarray(std, np.float32)).astype(np.float32)
    patch = frames[:, y0 : y0 + crop, x0 : x0 + crop]
    if flip:
        patch = patch[:, :, ::-1]
    if frames.dtype == np.uint8:
        out = patch.astype(np.float32) * np.float32(1.0 / 255.0)
    elif frames.dtype == np.float32:
        out = patch.copy()
    else:
        raise TypeError(f"frames must be uint8 or float32, got {frames.dtype}")
    out -= mean
    out *= inv_std
    return np.ascontiguousarray(out)


def audio_slice_gather(audio: np.ndarray, centers: np.ndarray, half: int) -> np.ndarray:
    """float32 (F, L) + (T,) centers -> (T, F, 2·half)."""
    centers = np.asarray(centers, np.int64)
    if centers.size and (centers.min() < half or centers.max() + half > audio.shape[1]):
        raise IndexError(f"audio slices {centers.min()}..{centers.max()} ±{half} "
                         f"outside {audio.shape[1]} columns")
    return np.stack([audio[:, i - half : i + half] for i in centers], axis=0)


def _round_half_even(v: float) -> int:
    return int(round(v))  # Python's round is banker's rounding, as the C++ rte


def gaze_heatmaps(
    gaze_loc: np.ndarray, num_frames: int, height: int, width: int, kernel_size: int
) -> np.ndarray:
    """Per-frame label heatmaps (T, H, W): the Gaussian stamp of
    ``kernel_size`` at each frame's gaze point, clipped at the borders and
    normalised to sum 1; uniform where the stamp misses the image."""
    k1 = gaussian_kernel_1d(kernel_size, -1.0)
    k2 = np.ascontiguousarray(k1 * k1.T, np.float32)
    gaze = np.asarray(gaze_loc[:num_frames, :2], np.float64)
    half = (kernel_size - 1) // 2
    out = np.zeros((num_frames, height, width), np.float32)
    for f in range(num_frames):
        mu_x = _round_half_even(gaze[f, 0] * width)
        mu_y = _round_half_even(gaze[f, 1] * height)
        left, right = max(mu_x - half, 0), min(mu_x + half, width - 1)
        top, bottom = max(mu_y - half, 0), min(mu_y + half, height - 1)
        total = 0.0
        if left < right and top < bottom:
            patch = k2[half - mu_y + top : half - mu_y + bottom + 1,
                       half - mu_x + left : half - mu_x + right + 1]
            out[f, top : bottom + 1, left : right + 1] = patch
            # the C++ loop's float64 sum in row order (np.cumsum is sequential)
            total = float(np.cumsum(patch.ravel().astype(np.float64))[-1])
        if total == 0.0:
            out[f] = np.float32(1.0) / np.float32(height * width)
        elif total != 1.0:
            out[f, top : bottom + 1, left : right + 1] *= np.float32(1.0 / total)
    return out

"""Host-side spatial transforms, numpy, explicitly seeded: the port's copy
of ``csts_tpu/data/transform.py``.

Re-designs the gaze-aware augmentations of ``slowfast/datasets/transform.py``
(random_short_side_scale_jitter :43-97, random_crop_gaze :155-197,
horizontal_flip_gaze :235-261, uniform_crop_gaze :327-387) for a functional input
pipeline: every random op takes a ``np.random.Generator`` instead of mutating global
state, and frames are ``(T, H, W, C)`` uint8/float32 numpy arrays.

The resize is ``F.interpolate(mode="bilinear", align_corners=False,
antialias=False)`` on the host, the half-pixel convention of the JAX
package's ``cv2.resize(..., INTER_LINEAR)``. cv2 rounds uint8 through 11-bit
fixed-point weights and PyTorch through its own, so a uint8 resize may
differ by one level on some pixels (``tests/test_torch_data.py`` measures
the share); float32 agrees to rounding.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from csts_torch import native


def short_side_scale(frames: np.ndarray, size: int) -> np.ndarray:
    """Resize so the short side equals ``size`` (no-op when already there)."""
    t, h, w, c = frames.shape
    if (w <= h and w == size) or (h <= w and h == size):
        return frames
    if w < h:
        new_w, new_h = size, int(math.floor(float(h) / w * size))
    else:
        new_w, new_h = int(math.floor(float(w) / h * size)), size
    x = torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2)
    out = F.interpolate(x, size=(new_h, new_w), mode="bilinear", align_corners=False,
                        antialias=False)
    return np.ascontiguousarray(out.permute(0, 2, 3, 1).numpy())


def random_short_side_scale_jitter(
    frames: np.ndarray, min_size: int, max_size: int, rng: np.random.Generator
) -> np.ndarray:
    size = int(round(rng.uniform(min_size, max_size)))
    return short_side_scale(frames, size)


def _crop_offset_1d(coords: np.ndarray, span: int, size: int, rng: np.random.Generator) -> int:
    """The gaze-constrained offset search of random_crop_gaze (transform.py:174-186):
    outlier gaze points are dropped pairwise until a window exists."""
    if span <= size:
        return 0
    s = np.sort(coords)
    low, high = max(0, s.max() - size), min(span - size, s.min())
    while low > high:
        s = s[1:] if len(s) % 2 == 0 else s[:-1]
        low, high = max(0, s.max() - size), min(span - size, s.min())
    return int(low) if low == high else int(rng.uniform(low, high))


def _crop(frames: np.ndarray, size: int, gaze_loc: np.ndarray, y0: int, x0: int
          ) -> Tuple[np.ndarray, np.ndarray]:
    """The window at (y0, x0) as a view, and the gaze points in its frame."""
    t, h, w, c = frames.shape
    out_gaze = gaze_loc.copy()
    out_gaze[:, 0] = np.clip((gaze_loc[:, 0] * w - x0) / size, 0, 1)
    out_gaze[:, 1] = np.clip((gaze_loc[:, 1] * h - y0) / size, 0, 1)
    return frames[:, y0 : y0 + size, x0 : x0 + size], out_gaze


def random_crop_gaze(
    frames: np.ndarray, size: int, gaze_loc: np.ndarray, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Random crop constrained to keep gaze points inside (transform.py:155-197).

    ``gaze_loc``: (T, K≥2) normalized [x, y, ...]; extra columns pass through.
    The gaze points are clipped to the window even where the frames are
    already at ``size`` (the JAX package's fused path, which its datasets
    run; the reference returns those untouched).
    """
    t, h, w, c = frames.shape
    x0 = _crop_offset_1d(gaze_loc[:, 0] * w, w, size, rng)
    y0 = _crop_offset_1d(gaze_loc[:, 1] * h, h, size, rng)
    return _crop(frames, size, gaze_loc, y0, x0)


def uniform_crop_gaze(
    frames: np.ndarray, size: int, spatial_idx: int, gaze_loc: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic left/center/right (or top/center/bottom) crop
    (transform.py:327-387)."""
    assert spatial_idx in (0, 1, 2)
    t, h, w, c = frames.shape
    y0 = int(math.ceil((h - size) / 2))
    x0 = int(math.ceil((w - size) / 2))
    if h > w:
        y0 = 0 if spatial_idx == 0 else (h - size if spatial_idx == 2 else y0)
    else:
        x0 = 0 if spatial_idx == 0 else (w - size if spatial_idx == 2 else x0)
    return _crop(frames, size, gaze_loc, y0, x0)


def horizontal_flip_gaze(
    frames: np.ndarray, gaze_loc: np.ndarray, rng: np.random.Generator, prob: float = 0.5
) -> Tuple[np.ndarray, np.ndarray]:
    """x → 1−x flip with probability ``prob`` (transform.py:235-261)."""
    out_gaze = gaze_loc.copy()
    if rng.uniform() < prob:
        frames = frames[:, :, ::-1]
        out_gaze[:, 0] = 1 - gaze_loc[:, 0]
    return frames, out_gaze


def spatial_sampling_fused(
    frames: np.ndarray,
    gaze_loc: np.ndarray,
    spatial_idx: int,
    min_scale: int,
    max_scale: int,
    crop_size: int,
    random_horizontal_flip: bool,
    rng: Optional[np.random.Generator],
    mean,
    std,
    normalize: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Normalize + the gaze-aware spatial sampling of the JAX package's
    ``spatial_sampling_gaze`` (datasets/utils.py:112-195): spatial_idx −1 →
    random jitter + crop (+ flip); 0/1/2 → deterministic scale + uniform crop.

    Input ``frames`` are raw uint8 (or [0,1] float); the scale happens on [0,1]
    floats (bilinear resize commutes with the affine normalization, so this matches
    the reference's normalize-then-resize order). The crop and flip are views,
    and (x−mean)/std runs over them in one pass (``csts_torch.native``). The
    generator is drawn in the reference's order (size, x offset, y offset, flip).

    ``normalize=False`` keeps uint8 frames uint8 end-to-end (resize included) and
    skips the /255 + mean/std affine — the device-side-normalization transfer
    path (DATA_LOADER.UINT8_TRANSFER): 4× less h2d per clip, with the affine
    folded into the forward (``CSTS.forward`` normalizes integer inputs). The only
    numerical difference is the resize's uint8 rounding (≤0.5/255 per
    pixel); with no resize the paths are bit-identical.
    """
    assert spatial_idx in (-1, 0, 1, 2)
    keep_uint8 = not normalize and frames.dtype == np.uint8
    # uint8 stays uint8 (UINT8_TRANSFER); float inputs pass through un-scaled
    # too — CSTS.forward only normalizes INTEGER dtypes on-device, so callers
    # must not hand float frames here expecting mean/std to happen later.
    assert normalize or keep_uint8 or not np.issubdtype(frames.dtype, np.floating), (
        "normalize=False with float frames would skip mean/std entirely"
    )
    if frames.dtype == np.uint8 and not keep_uint8:
        frames = frames.astype(np.float32) / 255.0
    if spatial_idx == -1:
        frames = random_short_side_scale_jitter(frames, min_scale, max_scale, rng)
        frames, gaze_loc = random_crop_gaze(frames, crop_size, gaze_loc, rng)
        if random_horizontal_flip:
            frames, gaze_loc = horizontal_flip_gaze(frames, gaze_loc, rng)
    else:
        assert min_scale == max_scale
        frames = short_side_scale(frames, min_scale)
        frames, gaze_loc = uniform_crop_gaze(frames, crop_size, spatial_idx, gaze_loc)
    if not normalize:
        return np.ascontiguousarray(frames), gaze_loc
    return native.fused_crop_flip_normalize(frames, 0, 0, crop_size, False, mean, std), gaze_loc

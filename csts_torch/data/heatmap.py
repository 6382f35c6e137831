"""The Gaussian kernel of the gaze-label heatmaps, the port's copy of
``csts_tpu/data/heatmap.py``'s (reference: ``ego4d_avgaze.py:449-468`` /
``ego4d_avgaze_forecast.py:403-422``). The heatmaps themselves are
``csts_torch.native.gaze_heatmaps``, the arithmetic of the JAX package's
C++ loader op, which its datasets and the port's run.

Replaces the cv2.getGaussianKernel dependency with the closed-form kernel —
cv2's default sigma for ksize k is ``0.3·((k−1)·0.5−1)+0.8`` and the kernel is
L1-normalized.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


# cv2's small_gaussian_tab: fixed kernels for ksize ≤ 7 when sigma is non-positive
_CV2_SMALL_KERNELS = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


@lru_cache(maxsize=8)
def gaussian_kernel_1d(ksize: int, sigma: float = -1.0) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma, CV_32F) equivalence."""
    if sigma <= 0 and ksize in _CV2_SMALL_KERNELS:
        return np.asarray(_CV2_SMALL_KERNELS[ksize], np.float32)[:, None]
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    k /= k.sum()
    return k.astype(np.float32)[:, None]

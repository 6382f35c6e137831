"""The one generator of the benchmark's inputs, driven by a cell's
``traffic`` parameters and the run's seed: seeded pools of clips made on the
device, gaze-label heatmaps, stochastic-depth factors and the open loop's
arrival schedule. Every seed gets the same amount of work (the same pool
sizes, the same set of gaps between arrivals) in another order and with
other values.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# what each seeded stream is for: one run draws each from its own generator
STREAMS = ("weights", "inputs", "labels", "drop", "arrivals", "sample")


def subseed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` of the run seeded ``seed`` (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, STREAMS.index(stream)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, stream))


def clips(batch: int, frames: int, crop: int, freq_bins: int, window: int,
          gen: torch.Generator, dtype: torch.dtype, audio: bool = True) -> Dict[str, torch.Tensor]:
    """One batch of normalised clips on ``gen``'s device: video (B, T, H, W, 3)
    and, with ``audio``, log-spectrogram slices (B, T, F, S, 1), standard normal."""
    dev = gen.device
    out = {"video": torch.randn(batch, frames, crop, crop, 3, generator=gen, device=dev,
                                dtype=dtype)}
    if audio:
        out["audio"] = torch.randn(batch, frames, freq_bins, window, 1, generator=gen,
                                   device=dev, dtype=dtype)
    return out


def gaze_heatmaps(batch: int, frames: int, size: int, kernel: int,
                  gen: torch.Generator) -> torch.Tensor:
    """Gaze labels (B, T, size, size) fp32: each frame a Gaussian stamp of
    ``kernel`` taps (OpenCV's default sigma for that size, as the datasets'
    GAUSSIAN_KERNEL) around a uniformly drawn point, cut at the borders and
    normalised to sum 1."""
    dev = gen.device
    sigma = 0.3 * ((kernel - 1) * 0.5 - 1) + 0.8
    pts = torch.rand(batch, frames, 2, generator=gen, device=dev) * size
    centre = pts.floor()
    axis = torch.arange(size, device=dev, dtype=torch.float32)
    dy = axis[None, None, :] - centre[..., 1:2]
    dx = axis[None, None, :] - centre[..., 0:1]
    half = kernel // 2
    gy = torch.exp(-dy ** 2 / (2 * sigma ** 2)) * (dy.abs() <= half)
    gx = torch.exp(-dx ** 2 / (2 * sigma ** 2)) * (dx.abs() <= half)
    hm = gy[..., :, None] * gx[..., None, :]
    return hm / hm.sum(dim=(2, 3), keepdim=True)


def drop_factors(rates: Sequence[float], batch: int, gen: torch.Generator,
                 device) -> List[Optional[tuple]]:
    """Per block: None where its stochastic-depth rate is 0, else the (B,)
    fp32 factors of its attention and MLP branches, bernoulli(1 - rate) /
    (1 - rate), drawn on the CPU."""
    out = []
    for r in rates:
        if r == 0.0:
            out.append(None)
            continue
        keep = 1.0 - r
        out.append(tuple((torch.rand(batch, generator=gen) < keep).float().div_(keep).to(device)
                         for _ in range(2)))
    return out


def open_loop(rate: float, seconds: float, seed: int) -> np.ndarray:
    """The due times (s from the window's start) of an open loop of Poisson
    arrivals at ``rate``/s over ``seconds``: round(rate·seconds) requests whose
    gaps are the exponential distribution's quantiles at (i + ½)/n, scaled
    to fill the window, in an order drawn from the seed."""
    n = max(1, round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= seconds / gaps.sum()
    rng = np.random.default_rng(subseed(seed, "arrivals"))
    gaps = gaps[rng.permutation(n)]
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def clip_order(n: int, pool: int, seed: int) -> np.ndarray:
    """Which pool clip each of ``n`` requests sends: the pool in an order
    drawn from the seed, repeated."""
    rng = np.random.default_rng(subseed(seed, "arrivals") + 1)
    return np.resize(rng.permutation(pool), n)


def sample(n: int, k: int, seed: int) -> List[int]:
    """``k`` of ``n`` indices drawn from the seed, in order."""
    rng = np.random.default_rng(subseed(seed, "sample"))
    return sorted(int(i) for i in rng.choice(n, size=min(k, n), replace=False))

"""Audio log-power STFT matching the reference's librosa preprocessing
(``csts_tpu/data/stft.py``; reference ``data/preprocess.py:276-304``):
n_fft=511 (-> 256 freq bins), a periodic hann window of 10 ms centred in
n_fft, hop 5 ms, centred with zero padding, ``log(|S|² + 1e-6)``.

:func:`stft_numpy` is the host version (the JAX package's, copied);
:func:`stft_torch` runs ``torch.stft`` on the samples' device and in their
dtype. The eval path reads precomputed STFTs; these serve the preprocessing
CLI (ROADMAP A.9).
"""

from __future__ import annotations

import numpy as np
import torch

N_FFT = 511
EPS = 1e-6


def _hann(win_length: int) -> np.ndarray:
    """Periodic (fftbins) Hann, scipy.signal.get_window('hann', n) equivalence."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


def _padded_window(win_length: int, n_fft: int = N_FFT) -> np.ndarray:
    """librosa centers a short window inside n_fft."""
    w = _hann(win_length)
    lpad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, np.float64)
    out[lpad : lpad + win_length] = w
    return out


def stft_params(sample_rate: int, window_ms: float = 10.0, hop_ms: float = 5.0):
    win_length = int(round(window_ms * sample_rate / 1e3))
    hop_length = int(round(hop_ms * sample_rate / 1e3))
    return win_length, hop_length


def stft_numpy(
    samples: np.ndarray, sample_rate: int = 24000, n_fft: int = N_FFT
) -> np.ndarray:
    """(num_samples,) float -> (n_fft//2+1, num_frames) log-power spectrogram."""
    win_length, hop_length = stft_params(sample_rate)
    window = _padded_window(win_length, n_fft)
    half = n_fft // 2
    x = np.pad(samples.astype(np.float64), (half, half), mode="constant")
    num_frames = 1 + (len(x) - n_fft) // hop_length
    strided = np.lib.stride_tricks.as_strided(
        x,
        shape=(num_frames, n_fft),
        strides=(x.strides[0] * hop_length, x.strides[0]),
    )
    spec = np.fft.rfft(strided * window, n=n_fft, axis=1).T  # (freq, time)
    power = np.real(spec * np.conj(spec))
    return np.log(power + EPS).astype(np.float32)


def stft_torch(samples: torch.Tensor, sample_rate: int = 24000, n_fft: int = N_FFT) -> torch.Tensor:
    """``torch.stft`` version of :func:`stft_numpy`: (num_samples,) float ->
    (n_fft//2+1, num_frames), in the samples' dtype and on their device.
    ``torch.stft`` centres the ``win_length`` window inside ``n_fft`` and
    pads the signal by ``n_fft // 2`` zeros a side, as librosa does."""
    win_length, hop_length = stft_params(sample_rate)
    window = torch.from_numpy(_hann(win_length)).to(samples.device, samples.dtype)
    spec = torch.stft(samples, n_fft, hop_length=hop_length, win_length=win_length,
                      window=window, center=True, pad_mode="constant", return_complex=True)
    power = spec.real.square() + spec.imag.square()
    return torch.log(power + EPS)

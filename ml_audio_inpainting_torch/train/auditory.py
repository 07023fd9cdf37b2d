"""Auditory-model quality metric: a PEMO-Q-class PSM score (port of
``ml_audio_inpainting_tpu/train/auditory.py``).

1. A gammatone filterbank: 4th-order gammatones on an ERB-spaced grid,
   applied as one batched FFT-domain convolution.  Its frequency response is
   built on the host in numpy (cached) and copied to each device once.
2. Hair-cell transduction: half-wave rectification and a 1 kHz one-pole
   low-pass, in the FFT domain.
3. Adaptation: 10 ms frame means, then log compression.
4. Modulation low-pass: an 8 Hz one-pole over the frames, in the FFT domain.
5. PSM: the per-channel Pearson correlation of the reference's and the
   test signal's internal representations, weighted by the reference
   channel's variance, in [-1, 1] (a signal against itself gives 1).

Every function takes ``(..., T)`` waveforms on any device and is batched
over the leading axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["gammatone_filterbank", "internal_representation", "psm_score"]


def _erb(f: np.ndarray) -> np.ndarray:
    """Equivalent rectangular bandwidth (Hz) at centre frequency ``f``
    (Glasberg & Moore 1990)."""
    return 24.7 + f / 9.265


def _erb_space(f_lo: float, f_hi: float, n: int) -> np.ndarray:
    """``n`` centre frequencies equally spaced on the ERB-number scale."""
    erb_lo = 21.4 * np.log10(1.0 + 0.00437 * f_lo)
    erb_hi = 21.4 * np.log10(1.0 + 0.00437 * f_hi)
    erbs = np.linspace(erb_lo, erb_hi, n)
    return (10.0 ** (erbs / 21.4) - 1.0) / 0.00437


@functools.lru_cache(maxsize=16)
def _gammatone_kernel_fft(sample_rate: int, n_channels: int, f_lo: float, f_hi: float,
                          kernel_len: int, nfft: int) -> np.ndarray:
    """The bank's frequency response ``(n_channels, nfft // 2 + 1)``
    complex64, each channel normalised to a peak gain of 1; host numpy."""
    fc = _erb_space(f_lo, f_hi, n_channels)
    b = 1.019 * _erb(fc)
    t = np.arange(kernel_len) / sample_rate
    g = (
        t[None, :] ** 3
        * np.exp(-2.0 * np.pi * b[:, None] * t[None, :])
        * np.cos(2.0 * np.pi * fc[:, None] * t[None, :])
    )
    H = np.abs(np.fft.rfft(g, n=4 * kernel_len, axis=-1))
    g = g / H.max(axis=-1, keepdims=True)
    return np.fft.rfft(g, n=nfft, axis=-1).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _gammatone_kernel_on(device: torch.device, *args) -> torch.Tensor:
    """:func:`_gammatone_kernel_fft` on ``device``, copied there once."""
    return torch.from_numpy(_gammatone_kernel_fft(*args)).to(device)


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _one_pole(n: int, rate: float, cutoff_hz: float, device) -> torch.Tensor:
    """``1 / (1 + j f / cutoff)`` at the ``n // 2 + 1`` rFFT bins of length
    ``n`` at ``rate``, complex64."""
    freqs = torch.fft.rfftfreq(n, 1.0 / rate, dtype=torch.float32, device=device)
    return 1.0 / (1.0 + 1j * (freqs / cutoff_hz))


def gammatone_filterbank(x: torch.Tensor, sample_rate: int = 16000, n_channels: int = 30,
                         f_lo: float = 80.0, f_hi: float = 7000.0,
                         kernel_len: int = 2048) -> torch.Tensor:
    """``(..., T)`` -> ``(..., n_channels, T)`` by FFT-domain convolution."""
    T = x.shape[-1]
    nfft = _pow2_at_least(T + kernel_len)
    K = _gammatone_kernel_on(x.device, sample_rate, n_channels, f_lo, f_hi, kernel_len, nfft)
    X = torch.fft.rfft(x, n=nfft)[..., None, :]
    return torch.fft.irfft(X * K, n=nfft)[..., :T]


def internal_representation(x: torch.Tensor, sample_rate: int = 16000, n_channels: int = 30,
                            frame: int = 160, mod_cutoff_hz: float = 8.0) -> torch.Tensor:
    """The auditory internal representation ``(..., C, n_frames)``:
    gammatone, half-wave rectification, 1 kHz low-pass, 10 ms frame means,
    log adaptation, 8 Hz modulation low-pass."""
    env = torch.clamp_min(gammatone_filterbank(x, sample_rate, n_channels), 0.0)

    T = env.shape[-1]
    nfft = _pow2_at_least(T)
    lp = _one_pole(nfft, sample_rate, 1000.0, env.device)
    env = torch.fft.irfft(torch.fft.rfft(env, n=nfft) * lp, n=nfft)[..., :T]
    env = torch.clamp_min(env, 0.0)

    n_frames = T // frame
    env = env[..., : n_frames * frame]
    env = env.reshape(env.shape[:-1] + (n_frames, frame)).mean(dim=-1)
    env = torch.log1p(env / 1e-4)

    mlp = _one_pole(n_frames, sample_rate / frame, mod_cutoff_hz, env.device)
    return torch.fft.irfft(torch.fft.rfft(env, n=n_frames) * mlp, n=n_frames)


def psm_score(reference: torch.Tensor, test: torch.Tensor, sample_rate: int = 16000,
              n_channels: int = 30, eps: float = 1e-9) -> torch.Tensor:
    """PSM in [-1, 1], one value per leading index of the ``(..., T)``
    inputs: the channel-variance-weighted Pearson correlation of the two
    internal representations over frames."""
    R = internal_representation(reference, sample_rate, n_channels)
    Y = internal_representation(test, sample_rate, n_channels)
    Rm = R - R.mean(dim=-1, keepdim=True)
    Ym = Y - Y.mean(dim=-1, keepdim=True)
    num = torch.sum(Rm * Ym, dim=-1)
    den = torch.sqrt(torch.sum(Rm**2, dim=-1) * torch.sum(Ym**2, dim=-1)) + eps
    corr = num / den
    w = torch.sum(Rm**2, dim=-1) + eps
    return torch.sum(corr * w, dim=-1) / torch.sum(w, dim=-1)

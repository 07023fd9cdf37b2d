"""Mel filterbanks and mel spectrograms, librosa's Slaney scale (port of
``ml_audio_inpainting_tpu/ops/mel.py``).

The filterbank is built on the host in numpy float64 (the port's own copy of
the JAX module's numpy code) and the projection is one ``torch.einsum`` on
the spectrogram's device.  :func:`mel_to_audio` inverts by the filterbank's
pseudo-inverse (``np.linalg.pinv`` on the host), then Griffin-Lim.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ml_audio_inpainting_torch.ops.griffinlim import griffinlim
from ml_audio_inpainting_torch.ops.stft import stft

__all__ = ["hz_to_mel", "mel_to_hz", "mel_filterbank", "mel_spectrogram", "mel_to_audio"]

# Slaney's scale: linear below 1 kHz, logarithmic above.
_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq, htk: bool = False) -> np.ndarray:
    """Hz -> mel (Slaney unless ``htk``), in float64."""
    freq = np.asanyarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    mels = freq / _F_SP
    log_t = freq >= _MIN_LOG_HZ
    return np.where(log_t, _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ)
                    / _LOGSTEP, mels)


def mel_to_hz(mels, htk: bool = False) -> np.ndarray:
    """Mel -> Hz (Slaney unless ``htk``), in float64."""
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    freqs = _F_SP * mels
    log_t = mels >= _MIN_LOG_MEL
    return np.where(log_t, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)), freqs)


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm: Optional[str] = "slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular filterbank ``(n_mels, 1 + n_fft // 2)``, as
    ``librosa.filters.mel``; ``fmax`` defaults to Nyquist."""
    if fmax is None:
        fmax = float(sample_rate) / 2
    fftfreqs = np.fft.rfftfreq(n=n_fft, d=1.0 / sample_rate)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2),
                      htk=htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        weights *= (2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels]))[:, None]
    elif norm is not None:
        raise ValueError(f"Unsupported norm: {norm!r}")
    return weights.astype(dtype)


def mel_spectrogram(
    y: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    power: float = 2.0,
) -> torch.Tensor:
    """Mel spectrogram ``(..., n_mels, N)`` of ``(..., T)``: ``|STFT|^power``
    projected on the filterbank (float64 on the host, cast to the
    spectrogram's dtype)."""
    mag = stft(y, n_fft=n_fft, hop_length=hop_length).abs() ** power
    fb = torch.as_tensor(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax, dtype=np.float64),
                         dtype=mag.dtype, device=mag.device)
    return torch.einsum("mf,...fn->...mn", fb, mag)


def mel_to_audio(
    mel_spec: torch.Tensor,
    sample_rate: int = 16000,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_iter: int = 32,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    power: float = 2.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Waveform of a mel spectrogram: the filterbank's pseudo-inverse maps it
    back to linear frequency, a power spectrogram takes its square root after
    the projection (negative leakage clamped to 0), then Griffin-Lim from a
    random start drawn from ``generator``."""
    fb = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax, dtype=np.float64)
    fb_pinv = torch.as_tensor(np.linalg.pinv(fb), dtype=mel_spec.dtype, device=mel_spec.device)
    linear = torch.einsum("fm,...mn->...fn", fb_pinv, mel_spec)
    if power == 2.0:
        linear = torch.sqrt(torch.clamp_min(linear, 0.0))
    return griffinlim(linear, n_iter=n_iter, n_fft=n_fft, hop_length=hop_length,
                      generator=generator)

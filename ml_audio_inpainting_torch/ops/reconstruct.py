"""Magnitude spectrogram -> waveform (port of
``ml_audio_inpainting_tpu/ops/reconstruct.py::spectrogram_to_audio``).

As the reference's ``spectrogram_to_audio``: a phase-bearing (complex)
spectrogram goes straight through the iSTFT; a real one is taken for dB when
its largest value and its mean are both negative and turned back into an
amplitude, then rebuilt with the given phase, or by Griffin-Lim without one.
"""

from __future__ import annotations

from typing import Optional

import torch

from ml_audio_inpainting_torch.ops.griffinlim import griffinlim
from ml_audio_inpainting_torch.ops.masking import db_to_amplitude
from ml_audio_inpainting_torch.ops.stft import istft

__all__ = ["spectrogram_to_audio"]


def spectrogram_to_audio(
    spectrogram: torch.Tensor,
    phase: Optional[torch.Tensor] = None,
    phase_info: bool = False,
    n_fft: int = 512,
    n_iter: int = 64,
    window: str = "hann",
    hop_length: int = 512,
    win_length: Optional[int] = None,
    center: bool = True,
    length: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The waveform of ``(..., F, N)`` magnitude (or, with ``phase_info``,
    complex) spectrograms.  The names and defaults are the reference's;
    ``length`` trims the output and ``generator`` seeds Griffin-Lim's random
    start.  The dB test is made on the card, with no host read: the choice
    is a ``torch.where``, as in the JAX function."""
    kw = dict(n_fft=n_fft, hop_length=hop_length, win_length=win_length, window=window,
              center=center, length=length)
    if phase_info:
        return istft(spectrogram, **kw)
    if not spectrogram.is_complex():
        is_db = (spectrogram.max() < 0) & (spectrogram.mean() < 0)
        spectrogram = torch.where(is_db, db_to_amplitude(spectrogram), spectrogram)
    if phase is not None:
        return istft(spectrogram * torch.polar(torch.ones_like(phase), phase), **kw)
    return griffinlim(spectrogram, n_iter=n_iter, generator=generator, **kw)

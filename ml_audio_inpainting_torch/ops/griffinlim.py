"""Batched momentum Griffin-Lim (port of
``ml_audio_inpainting_tpu/ops/griffinlim.py``).

librosa's accelerated update with ``momentum=0.99``: each iteration rebuilds
the waveform from the magnitude and the current phase, takes its STFT, and
steps the phase along ``rebuilt - momentum / (1 + momentum) * previous``.
The loop runs ``n_iter`` times in Python over the port's own
:func:`~ml_audio_inpainting_torch.ops.stft.stft` and ``istft``, the whole
batch at once, with no host read inside the loop.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ml_audio_inpainting_torch.ops.stft import istft, stft

__all__ = ["griffinlim"]

INIT_MODES = ("given", "random", "ones", "zeros")


def griffinlim(
    mag: torch.Tensor,
    n_iter: int = 64,
    n_fft: Optional[int] = None,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    window: str = "hann",
    center: bool = True,
    length: Optional[int] = None,
    momentum: float = 0.99,
    init: str = "random",
    generator: Optional[torch.Generator] = None,
    init_phase: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The waveform ``(..., length)`` of a magnitude spectrogram ``(..., F, N)``.

    ``init``: ``"given"`` starts from ``init_phase`` (radians, ``mag``'s
    shape); ``"random"`` from phases uniform in [0, 2 pi) drawn from
    ``generator`` (one on ``mag``'s device seeded with 0 when omitted; the
    JAX function draws from ``PRNGKey(0)``, and the two give other numbers);
    ``"ones"`` and ``"zeros"`` from phase 0.  The spectra are complex64, or
    complex128 for a float64 magnitude.  ``n_fft`` defaults to ``2 (F -
    1)``.
    """
    if n_fft is None:
        n_fft = 2 * (mag.shape[-2] - 1)
    if momentum < 0 or momentum >= 1:
        raise ValueError(f"momentum must be in [0, 1), got {momentum}")
    if init not in INIT_MODES:
        raise ValueError(f"init must be one of {INIT_MODES}, got {init!r}")

    if init == "given":
        if init_phase is None:
            raise ValueError("init='given' requires init_phase")
        angles = torch.polar(torch.ones_like(mag), init_phase.to(mag.dtype))
    elif init == "random":
        if generator is None:
            generator = torch.Generator(device=mag.device).manual_seed(0)
        phase = torch.rand(mag.shape, generator=generator, dtype=mag.dtype, device=mag.device)
        angles = torch.polar(torch.ones_like(mag), phase * (2.0 * math.pi))
    else:
        angles = torch.polar(torch.ones_like(mag), torch.zeros_like(mag))

    eps = torch.finfo(mag.dtype).tiny
    kw = dict(n_fft=n_fft, hop_length=hop_length, win_length=win_length, window=window,
              center=center)
    keep = momentum / (1.0 + momentum)
    rebuilt = torch.zeros_like(angles)
    for _ in range(n_iter):
        inverse = istft(mag * angles, length=length, **kw)
        new_rebuilt = stft(inverse, **kw)
        angles = new_rebuilt - keep * rebuilt
        angles = angles / (angles.abs() + eps)
        rebuilt = new_rebuilt
    return istft(mag * angles, length=length, **kw)

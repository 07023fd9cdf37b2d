"""16-bit PCM quantisation for the serving transport (port of
``ml_audio_inpainting_tpu/ops/pcm.py``): ``round(x * 32767)``, rounding half
to even as ``jnp.round`` does, clipped to the int16 range; the inverse
divides by the same scale, so every int16 level makes the round trip
exactly."""

from __future__ import annotations

import torch

__all__ = ["to_pcm16", "from_pcm16"]

_SCALE = 32767.0


def to_pcm16(x: torch.Tensor) -> torch.Tensor:
    """Float waveforms (nominally in [-1, 1]) to int16 PCM; values outside
    saturate."""
    return torch.clamp(torch.round(x * _SCALE), -32768.0, 32767.0).to(torch.int16)


def from_pcm16(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int16 PCM to float, the inverse of :func:`to_pcm16`."""
    return x.to(dtype) / _SCALE

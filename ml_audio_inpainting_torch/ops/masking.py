"""CNN+BiLSTM spectrogram normalisation (port of
``ml_audio_inpainting_tpu/ops/masking.py``): ``log10(|S| + 1e-9)`` and its
inverse ``10 ** x``."""

from __future__ import annotations

import torch

__all__ = ["LOG10_EPS", "log10_norm", "log10_denorm"]

LOG10_EPS = 1e-9


def log10_norm(mag: torch.Tensor) -> torch.Tensor:
    return torch.log10(mag + LOG10_EPS)


def log10_denorm(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x)

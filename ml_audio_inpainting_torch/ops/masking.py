"""Spectrogram normalisations, the mask-convention flip and the composite
(port of ``ml_audio_inpainting_tpu/ops/masking.py``).

* GAN profile: ``log1p(|S|)`` and its inverse ``expm1``;
* CNN+BiLSTM profile: ``log10(|S| + 1e-9)`` and its inverse ``10 ** x``;
* masks are 1 = valid / 0 = gap here and for the GAN; the CNN+BiLSTM takes
  1 = gap (:func:`invert_mask`);
* :func:`composite` keeps the prediction only inside the gap.
"""

from __future__ import annotations

import torch

__all__ = [
    "LOG10_EPS",
    "log1p_norm",
    "log1p_denorm",
    "log10_norm",
    "log10_denorm",
    "invert_mask",
    "composite",
]

LOG10_EPS = 1e-9


def log1p_norm(mag: torch.Tensor) -> torch.Tensor:
    return torch.log1p(mag)


def log1p_denorm(x: torch.Tensor) -> torch.Tensor:
    return torch.expm1(x)


def log10_norm(mag: torch.Tensor) -> torch.Tensor:
    return torch.log10(mag + LOG10_EPS)


def log10_denorm(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x)


def invert_mask(mask: torch.Tensor) -> torch.Tensor:
    """Swap 1 = valid and 1 = gap."""
    return 1.0 - mask


def composite(prediction: torch.Tensor, original: torch.Tensor,
              valid_mask: torch.Tensor) -> torch.Tensor:
    """``original`` where ``valid_mask`` is 1, ``prediction`` where it is 0:
    ``original * valid_mask + prediction * (1 - valid_mask)``."""
    return original * valid_mask + prediction * (1.0 - valid_mask)

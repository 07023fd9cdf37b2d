"""Spectrogram normalisations, the mask-convention flip and the composite
(port of ``ml_audio_inpainting_tpu/ops/masking.py``).

* GAN profile: ``log1p(|S|)`` and its inverse ``expm1``;
* CNN+BiLSTM profile: ``log10(|S| + 1e-9)`` and its inverse ``10 ** x``;
* masks are 1 = valid / 0 = gap here and for the GAN; the CNN+BiLSTM takes
  1 = gap (:func:`invert_mask`);
* :func:`composite` keeps the prediction only inside the gap;
* the dB helpers (:func:`amplitude_to_db`, :func:`db_to_amplitude`,
  :func:`power_to_db`) take librosa's rules.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = [
    "LOG10_EPS",
    "log1p_norm",
    "log1p_denorm",
    "log10_norm",
    "log10_denorm",
    "invert_mask",
    "composite",
    "amplitude_to_db",
    "db_to_amplitude",
    "power_to_db",
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


def amplitude_to_db(mag: torch.Tensor, ref: Union[float, torch.Tensor] = 1.0, amin: float = 1e-5,
                    top_db: Optional[float] = 80.0) -> torch.Tensor:
    """librosa's amplitude -> dB: :func:`power_to_db` of ``max(mag, amin)^2``
    against ``max(ref, amin)^2``."""
    ref_a = torch.clamp_min(torch.as_tensor(ref, dtype=mag.dtype, device=mag.device), amin)
    return power_to_db(torch.square(torch.clamp_min(mag, amin)), torch.square(ref_a), amin ** 2,
                       top_db)


def db_to_amplitude(db: torch.Tensor, ref: float = 1.0) -> torch.Tensor:
    """The inverse of :func:`amplitude_to_db` above its floor:
    ``ref * 10 ** (db / 20)``."""
    return ref * torch.pow(10.0, 0.5 * db / 10.0)


def power_to_db(power: torch.Tensor, ref: Union[float, torch.Tensor] = 1.0, amin: float = 1e-5,
                top_db: Optional[float] = 80.0) -> torch.Tensor:
    """librosa's power -> dB: ``10 (log10(max(power, amin)) -
    log10(max(ref, amin)))``, floored at ``top_db`` below the largest value."""
    p = torch.clamp_min(power, amin)
    ref_p = torch.clamp_min(torch.as_tensor(ref, dtype=power.dtype, device=power.device), amin)
    db = 10.0 * (torch.log10(p) - torch.log10(ref_p))
    if top_db is not None:
        db = torch.maximum(db, db.max() - top_db)
    return db

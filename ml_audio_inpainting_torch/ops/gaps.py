"""Gap masks (port of ``ml_audio_inpainting_tpu/ops/gaps.py``).

Mask convention: ``1.0 = valid signal, 0.0 = gap``.
"""

from __future__ import annotations

import torch

__all__ = ["gap_mask"]


def gap_mask(
    audio_len: int,
    gap_start: torch.Tensor,
    gap_len: torch.Tensor,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Mask ``(..., audio_len)`` with zeros on ``[start, start + len)``.

    ``gap_start`` and ``gap_len`` are integer tensors of one shape (``(B,)``
    for a batch, or scalars); the mask lies on their device.
    """
    idx = torch.arange(audio_len, device=gap_start.device)
    start = gap_start[..., None]
    inside = (idx >= start) & (idx < start + gap_len[..., None])
    return (~inside).to(dtype)

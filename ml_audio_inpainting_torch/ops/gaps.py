"""Gap masks (port of ``ml_audio_inpainting_tpu/ops/gaps.py``).

Mask convention: ``1.0 = valid signal, 0.0 = gap``.  Random draws take an
explicit ``torch.Generator`` where the JAX package takes a ``jax.random``
key; the two give different numbers from the same seed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["gap_mask", "random_gap_mask"]


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


def random_gap_mask(
    generator: Optional[torch.Generator],
    audio_len: int,
    gap_len_s: float,
    sample_rate: int = 16000,
    gap_start_s: Optional[float] = None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One single-gap mask ``(audio_len,)`` and its ``(start, end)`` in samples
    (port of ``random_gap_mask``, ``ops/gaps.py:49-79``).

    The gap is ``int(gap_len_s * sample_rate)`` samples long and starts
    uniformly over ``[0, audio_len - gap_len]`` inclusive (drawn from
    ``generator`` on the CPU), or at ``gap_start_s`` when given.  A gap of
    length <= 0 gives an all-ones mask and ``(0, 0)``; one at least as long
    as the audio gives all zeros and ``(0, audio_len)``.
    """
    gap_len = int(gap_len_s * sample_rate)
    zero = torch.zeros((), dtype=torch.int64)
    if gap_len <= 0:
        return torch.ones(audio_len, dtype=dtype), (zero, zero)
    if gap_len >= audio_len:
        return torch.zeros(audio_len, dtype=dtype), (zero, torch.full((), audio_len))
    if gap_start_s is None:
        start = torch.randint(0, audio_len - gap_len + 1, (), generator=generator)
    else:
        start = torch.full((), int(gap_start_s * sample_rate))
    return gap_mask(audio_len, start, torch.full((), gap_len), dtype=dtype), (start, start + gap_len)

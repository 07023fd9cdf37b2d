"""Gap masks (port of ``ml_audio_inpainting_tpu/ops/gaps.py``).

Mask convention: ``1.0 = valid signal, 0.0 = gap``.  Random draws take an
explicit ``torch.Generator`` where the JAX package takes a ``jax.random``
key; the two give different numbers from the same seed.  Where the JAX
functions take scalar gap bounds and are vmapped over a batch, these take
integer tensors of any one shape (``(B,)`` for a batch) and broadcast.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "gap_mask",
    "random_gap_mask",
    "apply_gap",
    "frame_mask_from_interval",
    "frame_mask_from_sample_mask",
]


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
    shape: Tuple[int, ...] = (),
    device=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Single-gap masks ``(*shape, audio_len)`` and their ``(start, end)``
    in samples, each ``shape`` (port of ``random_gap_mask``,
    ``ops/gaps.py:49-79``, which draws one; ``shape=(B,)`` draws a batch in
    one call, where JAX vmaps it over B keys).

    A gap is ``int(gap_len_s * sample_rate)`` samples long and starts
    uniformly over ``[0, audio_len - gap_len]`` inclusive (drawn from
    ``generator`` on the CPU, then moved to ``device``), or at
    ``gap_start_s`` when given.  A gap of length <= 0 gives an all-ones mask
    and ``(0, 0)``; one at least as long as the audio gives all zeros and
    ``(0, audio_len)``.  The masks lie on ``device`` (the CPU by default).
    """
    gap_len = int(gap_len_s * sample_rate)
    zero = torch.zeros(shape, dtype=torch.int64, device=device)
    if gap_len <= 0:
        return torch.ones((*shape, audio_len), dtype=dtype, device=device), (zero, zero)
    if gap_len >= audio_len:
        return (torch.zeros((*shape, audio_len), dtype=dtype, device=device),
                (zero, torch.full(shape, audio_len, device=device)))
    if gap_start_s is None:
        start = torch.randint(0, audio_len - gap_len + 1, shape, generator=generator).to(device)
    else:
        start = torch.full(shape, int(gap_start_s * sample_rate), device=device)
    length = torch.full(shape, gap_len, device=device)
    return gap_mask(audio_len, start, length, dtype=dtype), (start, start + gap_len)


def apply_gap(audio: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero the gap: ``audio * mask`` (``ops/gaps.py:82``)."""
    return audio * mask


def frame_mask_from_interval(
    gap_start: torch.Tensor,
    gap_end: torch.Tensor,
    n_freq: int,
    n_time: int,
    hop_length: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Spectrogram mask ``(..., n_freq, n_time)`` of the sample interval
    ``[gap_start, gap_end)`` (``ops/gaps.py:88-107``): frames
    ``[start // hop, ceil(end / hop))`` are holes (0), the rest valid (1); an
    empty interval (``end <= start``) has no hole.  A view, broadcast over
    frequency."""
    start_f = (gap_start // hop_length)[..., None]
    end_f = (-((-gap_end) // hop_length))[..., None]
    t = torch.arange(n_time, device=gap_start.device)
    hole = (t >= start_f) & (t < end_f) & (gap_end > gap_start)[..., None]
    col = (~hole).to(dtype)
    return col[..., None, :].expand(*col.shape[:-1], n_freq, n_time)


def frame_mask_from_sample_mask(
    sample_mask: torch.Tensor,
    n_freq: int,
    n_time: int,
    hop_length: int,
    rule: str = "any",
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Frame mask ``(..., n_freq, n_time)`` of a 1 = valid sample mask
    ``(..., n_samples)`` (``ops/gaps.py:110-145``).

    ``rule="any"``: frame ``t`` is a hole iff a sample of
    ``[t * hop, (t + 1) * hop)`` is missing (the floor/ceil rule for one
    interval).  ``rule="end"``: iff sample ``t * hop + hop - 1`` is missing
    (the CNN+BiLSTM floor/floor rule).  Samples past the mask's end count as
    present; samples past ``n_time * hop`` are ignored."""
    if rule not in ("any", "end"):
        raise ValueError(f"rule must be 'any' or 'end', got {rule!r}")
    miss = 1.0 - sample_mask
    total = n_time * hop_length
    n = miss.shape[-1]
    miss = F.pad(miss, (0, total - n)) if total > n else miss[..., :total]
    windows = miss.reshape(*miss.shape[:-1], n_time, hop_length)
    hole = windows.amax(dim=-1) if rule == "any" else windows[..., -1]
    col = (~(hole > 0)).to(dtype)
    return col[..., None, :].expand(*col.shape[:-1], n_freq, n_time)

"""Multi-gap corruption: several gaps a clip with spacing constraints (port
of ``ml_audio_inpainting_tpu/data/multigap.py::multi_gap_mask``).

The JAX function draws two sets of K uniforms from the halves of a
``jax.random`` key (the gap lengths, then the positions) and lays the gaps
out from them without rejection: lengths first, shrunk in proportion if
they do not fit, then the free space shared between the K+1 slots by
stick-breaking over the sorted position uniforms, with ``min_dist_samples``
reserved between gaps and at both edges.  Here :func:`multi_gap_layout` is
that layout as a pure function of the two uniform draws, computed in
float32 and int32 exactly as JAX computes it (lengths truncated to int32,
the proportional shrink and the slot widths in f32), so the same uniforms
give the same ``starts``, ``lengths`` and mask bit for bit, on the
uniforms' device.  :func:`random_multi_gap_layout` draws the uniforms from an explicit
``torch.Generator`` instead of a key (the two give different numbers).
Every function takes leading batch dimensions: ``(..., K)`` draws give
``(..., K)`` gaps and ``(..., audio_len)`` masks.

Mask convention: ``1.0 = signal, 0.0 = gap``.  :func:`apply_gaps_with_fades`
is the IRMAS gap tables' faded corruption (cos^2 ramps just outside each gap),
and :func:`eval_gap_table` the fixed evaluation masks (one gap a signal,
80 ms at 2 s by default), both served by the mask-driven inpaint functions.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "multi_gap_layout",
    "gaps_mask",
    "multi_gap_mask",
    "random_multi_gap_layout",
    "cos2_fade",
    "apply_gaps_with_fades",
    "eval_gap_table",
]

# multi_gap_mask's defaults (data/multigap.py:30-38).
MIN_GAP_MS = 10.0
MAX_GAP_MS = 80.0
MIN_DIST_SAMPLES = 4096
MIN_LENGTH = 16  # the shortest gap a shrink leaves


def multi_gap_layout(
    u_len: torch.Tensor,
    u_pos: torch.Tensor,
    audio_len: int,
    min_gap_ms: float = MIN_GAP_MS,
    max_gap_ms: float = MAX_GAP_MS,
    sample_rate: int = 16000,
    min_dist_samples: int = MIN_DIST_SAMPLES,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(starts, lengths)``, int32 ``(..., K)``, of the gaps that ``u_len``
    and ``u_pos``, float32 uniforms in [0, 1) of shape ``(..., K)``, lay out
    (``multigap.py:49-74``).

    The lengths are ``max(min_len, u_len * (max_len - min_len) + min_len)``
    samples (``jax.random.uniform``'s map onto [min_len, max_len)) truncated
    to int32; if they and the reserved spacing overrun the clip they are
    scaled by ``(audio_len - reserved) / total`` (clipped to [0.05, 1]) and
    kept at least 16.  The gaps are ordered, at least ``min_dist_samples``
    apart and from either edge, as long as the budget fits.
    """
    if u_len.shape != u_pos.shape:
        raise ValueError(f"u_len {tuple(u_len.shape)} and u_pos {tuple(u_pos.shape)} differ")
    f32, i32 = torch.float32, torch.int32
    u_len, u_pos = u_len.to(f32), u_pos.to(f32)
    n_gaps = u_len.shape[-1]
    # Constants made where the uniforms are (a fill, not a host copy: no sync on a card).
    const = functools.partial(torch.full, (), dtype=f32, device=u_len.device)
    min_len = const(min_gap_ms * sample_rate / 1000.0)
    max_len = const(max_gap_ms * sample_rate / 1000.0)
    lengths = torch.maximum(min_len, u_len * (max_len - min_len) + min_len).to(i32)

    total = lengths.sum(-1, keepdim=True, dtype=i32)
    reserved = (n_gaps + 1) * min_dist_samples
    free = audio_len - total - reserved
    shrink = const(float(audio_len - reserved)) / torch.clamp_min(total, 1).to(f32)
    scale = torch.where(free < 0, shrink, const(1.0))
    lengths = torch.clamp_min((lengths.to(f32) * torch.clamp(scale, 0.05, 1.0)).to(i32), MIN_LENGTH)
    total = lengths.sum(-1, keepdim=True, dtype=i32)
    free = torch.clamp_min(audio_len - total - reserved, 0)

    # Stick-breaking: the free space over the K+1 slots, cut at the sorted uniforms.
    u = torch.sort(u_pos, dim=-1).values
    edge = torch.zeros((*u.shape[:-1], 1), dtype=f32, device=u.device)
    bounds = torch.cat([edge, u, edge + 1.0], dim=-1)
    slots = (torch.diff(bounds, dim=-1) * free.to(f32)).to(i32)  # (..., K+1)

    gap_offsets = torch.cumsum(lengths, -1, dtype=i32) - lengths
    spacing = torch.cumsum(slots[..., :-1], -1, dtype=i32) + min_dist_samples * (
        torch.arange(n_gaps, dtype=i32, device=u.device) + 1)
    return spacing + gap_offsets, lengths


def gaps_mask(
    audio_len: int, starts: torch.Tensor, lengths: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Mask ``(..., audio_len)`` of ``(..., K)`` integer gaps: 0 on every
    ``[start, start + length)``, 1 elsewhere (``multigap.py:76-80``); on the
    gaps' device."""
    idx = torch.arange(audio_len, device=starts.device)
    start, end = starts[..., None], (starts + lengths)[..., None]
    in_any = ((idx >= start) & (idx < end)).any(dim=-2)
    return (~in_any).to(dtype)


def multi_gap_mask(
    u_len: torch.Tensor,
    u_pos: torch.Tensor,
    audio_len: int,
    min_gap_ms: float = MIN_GAP_MS,
    max_gap_ms: float = MAX_GAP_MS,
    sample_rate: int = 16000,
    min_dist_samples: int = MIN_DIST_SAMPLES,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mask, starts, lengths)`` of :func:`multi_gap_layout`'s gaps, as
    ``multi_gap_mask`` returns them: the f32 mask ``(..., audio_len)`` (1 =
    signal) and the int32 ``(..., K)`` gaps."""
    starts, lengths = multi_gap_layout(u_len, u_pos, audio_len, min_gap_ms, max_gap_ms,
                                       sample_rate, min_dist_samples)
    return gaps_mask(audio_len, starts, lengths), starts, lengths


def random_multi_gap_layout(
    generator: torch.Generator,
    shape: Tuple[int, ...],
    audio_len: int,
    n_gaps: int,
    min_gap_ms: float = MIN_GAP_MS,
    max_gap_ms: float = MAX_GAP_MS,
    sample_rate: int = 16000,
    min_dist_samples: int = MIN_DIST_SAMPLES,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(starts, lengths)``, int32 ``(*shape, n_gaps)``: the layout of
    uniforms drawn on the CPU from ``generator``, the lengths' first."""
    u_len = torch.rand((*shape, n_gaps), generator=generator, dtype=torch.float32)
    u_pos = torch.rand((*shape, n_gaps), generator=generator, dtype=torch.float32)
    return multi_gap_layout(u_len, u_pos, audio_len, min_gap_ms, max_gap_ms, sample_rate,
                            min_dist_samples)


def cos2_fade(fade_len: int, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """A cos^2 ramp from 1 to 0 over ``fade_len`` samples
    (``multigap.py:84-87``)."""
    t = torch.linspace(0.0, math.pi / 2, fade_len, dtype=dtype, device=device)
    return torch.cos(t) ** 2


def apply_gaps_with_fades(audio: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
                          fade_len: int = 32) -> torch.Tensor:
    """``audio`` ``(..., n)`` with each gap of ``(..., K)`` ``starts`` and
    ``lengths`` zeroed, a cos^2 fade-out over the ``fade_len`` samples before
    it and a fade-in over those after it (``multigap.py:90-121``); where
    ramps meet, the smaller gain wins."""
    n = audio.shape[-1]
    idx = torch.arange(n, device=audio.device)
    gain = torch.ones(audio.shape, dtype=audio.dtype, device=audio.device)
    zero = torch.zeros((), dtype=audio.dtype, device=audio.device)
    for g in range(starts.shape[-1]):
        s, e = starts[..., g, None], (starts[..., g] + lengths[..., g])[..., None]
        gain = torch.where((idx >= s) & (idx < e), zero, gain)
        fo = torch.cos((math.pi / 2) * (1.0 - (s - idx).to(audio.dtype) / fade_len)) ** 2
        gain = torch.where((idx >= s - fade_len) & (idx < s), torch.minimum(gain, fo), gain)
        fi = torch.cos((math.pi / 2) * (1.0 - (idx - e).to(audio.dtype) / fade_len)) ** 2
        gain = torch.where((idx >= e) & (idx < e + fade_len), torch.minimum(gain, fi), gain)
    return audio * gain


def eval_gap_table(n_signals: int, audio_len: int = 80000, gap_len_samples: int = 1280,
                   gap_start_samples: int = 32000) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The fixed masks of the standard evaluation condition, one gap of
    ``gap_len_samples`` at ``gap_start_samples`` a signal
    (``multigap.py:124-140``): ``(masks (n_signals, audio_len) f32, starts,
    lengths (n_signals,) int32)``, numpy arrays on the host."""
    mask = np.ones((n_signals, audio_len), np.float32)
    mask[:, gap_start_samples : gap_start_samples + gap_len_samples] = 0.0
    starts = np.full((n_signals,), gap_start_samples, np.int32)
    lengths = np.full((n_signals,), gap_len_samples, np.int32)
    return mask, starts, lengths

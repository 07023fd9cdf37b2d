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
give the same ``starts``, ``lengths`` and mask bit for bit.
:func:`random_multi_gap_layout` draws the uniforms from an explicit
``torch.Generator`` instead of a key (the two give different numbers).
Every function takes leading batch dimensions: ``(..., K)`` draws give
``(..., K)`` gaps and ``(..., audio_len)`` masks.

Mask convention: ``1.0 = signal, 0.0 = gap``.  ``cos2_fade``,
``apply_gaps_with_fades`` and ``eval_gap_table`` are not ported yet: no
ported path uses them.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["multi_gap_layout", "gaps_mask", "multi_gap_mask", "random_multi_gap_layout"]

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
    min_len = torch.tensor(min_gap_ms * sample_rate / 1000.0, dtype=f32)
    max_len = torch.tensor(max_gap_ms * sample_rate / 1000.0, dtype=f32)
    lengths = torch.maximum(min_len, u_len * (max_len - min_len) + min_len).to(i32)

    total = lengths.sum(-1, keepdim=True, dtype=i32)
    reserved = (n_gaps + 1) * min_dist_samples
    free = audio_len - total - reserved
    shrink = torch.tensor(float(audio_len - reserved), dtype=f32) / torch.clamp_min(total, 1).to(f32)
    scale = torch.where(free < 0, shrink, torch.ones((), dtype=f32))
    lengths = torch.clamp_min((lengths.to(f32) * torch.clamp(scale, 0.05, 1.0)).to(i32), MIN_LENGTH)
    total = lengths.sum(-1, keepdim=True, dtype=i32)
    free = torch.clamp_min(audio_len - total - reserved, 0)

    # Stick-breaking: the free space over the K+1 slots, cut at the sorted uniforms.
    u = torch.sort(u_pos, dim=-1).values
    edge = torch.zeros((*u.shape[:-1], 1), dtype=f32)
    bounds = torch.cat([edge, u, edge + 1.0], dim=-1)
    slots = (torch.diff(bounds, dim=-1) * free.to(f32)).to(i32)  # (..., K+1)

    gap_offsets = torch.cumsum(lengths, -1, dtype=i32) - lengths
    spacing = torch.cumsum(slots[..., :-1], -1, dtype=i32) + min_dist_samples * (
        torch.arange(n_gaps, dtype=i32) + 1)
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

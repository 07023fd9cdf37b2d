"""The general traffic generator: seeded speech-like clips and gap layouts,
made on the device from a ``torch.Generator`` there, in a few large calls.
A mix file under ``mixes/`` sets the numbers; nothing here is per mix.

Clips are the port's synthetic speech (an AM-modulated harmonic stack over a
noise floor, peak 1): per clip an f0 of U(90, 180) Hz with a 30 Hz vibrato
at U(0.4, 1.0) Hz, five harmonics of amplitude 0.5 / k, an envelope at
U(1.5, 3.0) Hz, and N(0, 0.01^2) noise, normalised to a peak of 1.

Training gaps are the published recipe's multi-gap layout (lengths first,
shrunk in proportion when they do not fit, then the free space shared
between the K + 1 slots by stick-breaking over sorted uniforms, 4096
samples kept between gaps and from either edge), in f32 and int32 as the
recipe computes it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

MIN_DIST = 4096
MIN_LENGTH = 16


def speech_clips(gen: torch.Generator, n: int, samples: int, sample_rate: int,
                 chunk: int = 256) -> torch.Tensor:
    """``(n, samples)`` f32 clips on ``gen``'s device."""
    dev = gen.device
    out = torch.empty((n, samples), device=dev)
    t = torch.arange(samples, device=dev, dtype=torch.float64) / sample_rate
    for lo in range(0, n, chunk):
        b = min(chunk, n - lo)
        u = torch.rand((b, 3), generator=gen, device=dev, dtype=torch.float64)
        f0 = (90 + 90 * u[:, :1]) + 30 * torch.sin(2 * math.pi * (0.4 + 0.6 * u[:, 1:2]) * t)
        phase = 2 * math.pi * torch.cumsum(f0, dim=1) / sample_rate
        sig = sum((0.5 / k) * torch.sin(k * phase) for k in range(1, 6))
        env = 0.5 * (1 + torch.sin(2 * math.pi * (1.5 + 1.5 * u[:, 2:3]) * t))
        noise = torch.randn((b, samples), generator=gen, device=dev)
        sig = (env * sig).float() + 0.01 * noise
        out[lo:lo + b] = sig / sig.abs().amax(dim=1, keepdim=True)
    return out


def serve_gaps(gen: torch.Generator, shape: Tuple[int, ...], samples: int, sample_rate: int,
               gap_ms: Tuple[float, float], window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(start, length)`` int64 of ``shape``: one gap a clip, its length
    uniform over the integer samples of ``gap_ms``, its start uniform over
    ``[0, samples - window]``, so that the ``window`` samples from its start
    lie in the clip and hold the whole gap."""
    lo, hi = (int(round(ms * sample_rate / 1000.0)) for ms in gap_ms)
    if hi > window:
        raise ValueError(f"gaps of up to {hi} samples do not fit a {window}-sample patch")
    length = torch.randint(lo, hi + 1, shape, generator=gen, device=gen.device)
    start = torch.randint(0, samples - window + 1, shape, generator=gen, device=gen.device)
    return start, length


def multi_gap_layout(u_len: torch.Tensor, u_pos: torch.Tensor, samples: int, min_ms: float,
                     max_ms: float, sample_rate: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(starts, lengths)``, int32 ``(..., K)``, that the uniforms ``u_len``
    and ``u_pos`` (``(..., K)`` f32 in [0, 1)) lay out."""
    f32, i32 = torch.float32, torch.int32
    k = u_len.shape[-1]
    dev = u_len.device
    min_len = torch.tensor(min_ms * sample_rate / 1000.0, dtype=f32, device=dev)
    max_len = torch.tensor(max_ms * sample_rate / 1000.0, dtype=f32, device=dev)
    lengths = torch.maximum(min_len, u_len * (max_len - min_len) + min_len).to(i32)
    total = lengths.sum(-1, keepdim=True, dtype=i32)
    reserved = (k + 1) * MIN_DIST
    free = samples - total - reserved
    shrink = torch.tensor(float(samples - reserved), dtype=f32, device=dev) / torch.clamp_min(
        total, 1).to(f32)
    scale = torch.where(free < 0, shrink, torch.ones((), dtype=f32, device=dev))
    lengths = torch.clamp_min((lengths.to(f32) * torch.clamp(scale, 0.05, 1.0)).to(i32), MIN_LENGTH)
    total = lengths.sum(-1, keepdim=True, dtype=i32)
    free = torch.clamp_min(samples - total - reserved, 0)
    u = torch.sort(u_pos, dim=-1).values
    edge = torch.zeros((*u.shape[:-1], 1), dtype=f32, device=dev)
    slots = (torch.diff(torch.cat([edge, u, edge + 1.0], dim=-1), dim=-1) * free.to(f32)).to(i32)
    offsets = torch.cumsum(lengths, -1, dtype=i32) - lengths
    spacing = torch.cumsum(slots[..., :-1], -1, dtype=i32) + MIN_DIST * (
        torch.arange(k, dtype=i32, device=dev) + 1)
    return spacing + offsets, lengths


def train_gaps(gen: torch.Generator, shape: Tuple[int, ...], n_gaps: int, samples: int,
               sample_rate: int, min_ms: float, max_ms: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(starts, lengths)``, int64 ``(*shape, n_gaps)``, drawn on ``gen``'s
    device: the lengths' uniforms first, then the positions'."""
    full = (*shape, n_gaps)
    u_len = torch.rand(full, generator=gen, device=gen.device)
    u_pos = torch.rand(full, generator=gen, device=gen.device)
    starts, lengths = multi_gap_layout(u_len, u_pos, samples, min_ms, max_ms, sample_rate)
    return starts.to(torch.int64), lengths.to(torch.int64)

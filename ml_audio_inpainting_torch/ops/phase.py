"""Deployable gap-phase estimation by phase-vocoder extrapolation (port of
``ml_audio_inpainting_tpu/ops/phase.py``).

The phase inside a gap is lost with its samples.  :func:`extrapolate_phase`
estimates it from what survives: each bin's instantaneous frequency
measured on the last two trustworthy frames before the gap (and the first
two after it), extrapolated linearly in time from both sides and blended on
the unit circle with a cos^2 crossfade.  A stationary partial near bin ``f``
advances its phase by ``omega[f] + princarg(dphi[f] - omega[f])`` a hop,
with ``omega[f] = 2 pi f hop / n_fft``.

No per-gap Python: the boundary frames come from running maximum/minimum
scans along the frames (``torch.cummax``, and ``torch.cummin`` over the
flipped frames, where the JAX module takes associative scans), the boundary
phases from gathers on clamped indices.  :func:`window_clear_frame_mask`
says which frames may be trusted: those whose whole analysis window avoids
every missing sample.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["princarg", "window_clear_frame_mask", "extrapolate_phase"]


def princarg(x: torch.Tensor) -> torch.Tensor:
    """Principal argument: ``x`` wrapped to [-pi, pi] (round half to even,
    as ``jnp.round``)."""
    return x - 2.0 * math.pi * torch.round(x / (2.0 * math.pi))


def window_clear_frame_mask(
    sample_valid: torch.Tensor,
    n_frames: int,
    hop_length: int,
    n_fft: int,
    win_length: Optional[int] = None,
) -> torch.Tensor:
    """``(B, n_frames)``: 1 where the frame's analysis window touches no
    invalid sample of ``sample_valid`` (``(B, S)``, 1 = valid), else 0.

    With ``center=True`` frame ``t``'s window spans ``[t * hop - wl // 2,
    t * hop + wl - wl // 2)`` of the signal, ``wl`` being ``win_length``
    (``n_fft`` when omitted), so a frame whose centre lies outside a gap can
    still carry the lost samples' phase.  Samples outside the signal count
    as valid.  In ``sample_valid``'s dtype.
    """
    wl = win_length if win_length is not None else n_fft
    inv = (sample_valid < 0.5).to(torch.int64)
    c = F.pad(torch.cumsum(inv, dim=-1), (1, 0))  # c[:, i]: invalid samples before i
    s = sample_valid.shape[-1]
    centers = torch.arange(n_frames, device=sample_valid.device) * hop_length
    lo = torch.clamp(centers - wl // 2, 0, s)
    hi = torch.clamp(centers + (wl - wl // 2), 0, s)
    overlap = c[:, hi] - c[:, lo]
    return (overlap == 0).to(sample_valid.dtype)


def extrapolate_phase(
    phase: torch.Tensor, frame_valid: torch.Tensor, hop_length: int, n_fft: int
) -> torch.Tensor:
    """The phase ``(B, F, N)`` with every frame where ``frame_valid``
    (``(B, N)``) is below 0.5 replaced by the extrapolation from the nearest
    trustworthy frames on each side; trustworthy frames pass through.

    A side's advance is measured only where its two boundary frames are both
    trustworthy; otherwise (a gap at the clip's edge, or a valid run one
    frame long between two gaps) it is the nominal ``omega``.  A side with
    no trustworthy frame gets weight 0; where the blend cancels exactly the
    phase is 0.
    """
    b, n_bins, n = phase.shape
    device = phase.device
    t = torch.arange(n, device=device)
    valid = frame_valid > 0.5

    # Last trustworthy frame <= t (-1 where none yet); first >= t (n where none).
    lv = torch.cummax(torch.where(valid, t, -1), dim=1).values
    rv = torch.cummin(torch.where(valid, t, n).flip(1), dim=1).values.flip(1)

    def take(i: torch.Tensor) -> torch.Tensor:
        # (B, F, N) phases at frame i (B, N), clamped into range
        idx = torch.clamp(i, 0, n - 1)[:, None, :].expand(b, n_bins, n)
        return torch.gather(phase, 2, idx)

    def frame_is_valid(i: torch.Tensor) -> torch.Tensor:
        return torch.gather(valid, 1, torch.clamp(i, 0, n - 1))

    omega = (2.0 * math.pi * hop_length / n_fft) * torch.arange(
        n_bins, device=device, dtype=phase.dtype)
    omega = omega[None, :, None]

    lv2 = lv - 1
    l_ok = ((lv2 >= 0) & frame_is_valid(lv2))[:, None, :]
    ph_l = take(lv)
    dphi_l = torch.where(l_ok, princarg(ph_l - take(lv2) - omega) + omega, omega)
    steps_l = torch.clamp(t[None, :] - lv, min=0)[:, None, :]
    ph_ext_l = ph_l + steps_l * dphi_l

    rv2 = rv + 1
    r_ok = ((rv2 <= n - 1) & frame_is_valid(rv2))[:, None, :]
    ph_r = take(rv)
    dphi_r = torch.where(r_ok, princarg(take(rv2) - ph_r - omega) + omega, omega)
    steps_r = torch.clamp(rv - t[None, :], min=0)[:, None, :]
    ph_ext_r = ph_r - steps_r * dphi_r

    # cos^2 crossfade in time; a side with no trustworthy frame weighs 0.
    has_l = (lv >= 0)[:, None, :]
    has_r = (rv <= n - 1)[:, None, :]
    span = torch.clamp(rv - lv, min=1)[:, None, :]
    zero = torch.zeros((), dtype=phase.dtype, device=device)
    one = torch.ones((), dtype=phase.dtype, device=device)
    w_l = torch.where(has_l, ((rv[:, None, :] - t[None, None, :]) / span).to(phase.dtype), zero)
    w_l = torch.sin(0.5 * math.pi * w_l) ** 2
    w_l = torch.where(has_r, w_l, torch.where(has_l, one, zero))
    w_r = torch.where(has_r, 1.0 - w_l, zero)

    re = w_l * torch.cos(ph_ext_l) + w_r * torch.cos(ph_ext_r)
    im = w_l * torch.sin(ph_ext_l) + w_r * torch.sin(ph_ext_r)
    cancelled = torch.hypot(re, im) < 1e-12  # an exactly cancelling blend: angle of 1
    ext = torch.where(cancelled, zero, torch.atan2(im, re))
    return torch.where(valid[:, None, :], phase, ext)

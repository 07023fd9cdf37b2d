"""Windowed overlap-add segmentation (port of
``ml_audio_inpainting_tpu/classical/ola.py``).

Cut ``w``-sample windows every ``a`` samples, run Janssen on each window that
the gap can touch, and recombine by overlap-add rescaled by ``sum(g_ana *
g_syn)`` (``segmentation_inp.m``).  Only the ``K`` windows that can touch a
gap of ``max_gap`` samples are solved, all windows of all clips as one
batched Janssen solve; the rest pass through the overlap-add as the
identity, so the update is local around the gap.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ml_audio_inpainting_torch.classical._slices import clamped_window
from ml_audio_inpainting_torch.classical.janssen import janssen
from ml_audio_inpainting_torch.ops.stft import get_window

__all__ = ["ola_windows", "segmentation_inpaint", "gap_windows", "overlap_add_update"]


def ola_windows(wtype: str, w: int, dtype: torch.dtype = torch.float32,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(analysis, synthesis) window pair, computed in f64 on ``device``.

    ``hann``: the peak-normalised periodic Hann for both; ``rect``: ones,
    then Hann; ``tukey``: Tukey(0.5) for both (``segmentation_inp.m:73-87``).
    """
    hann = get_window("hann", w, torch.float64, device)
    if wtype == "hann":
        g = (hann / hann.max()).to(dtype)
        return g, g
    if wtype == "rect":
        return torch.ones(w, dtype=dtype, device=device), (hann / hann.max()).to(dtype)
    if wtype == "tukey":
        r = 0.5
        edge = math.floor(r * (w - 1) / 2)
        n = torch.arange(edge + 1, dtype=torch.float64, device=device)
        ramp = 0.5 * (1 + torch.cos(torch.pi * (2 * n / (r * (w - 1)) - 1)))
        t = torch.ones(w, dtype=torch.float64, device=device)
        t[: edge + 1] = ramp
        t[w - edge - 1 :] = ramp.flip(0)
        return t.to(dtype), t.to(dtype)
    raise ValueError(f"Unsupported OLA window: {wtype!r}")


def gap_windows(x: torch.Tensor, mask: torch.Tensor, gap_start: torch.Tensor, w: int, a: int,
                max_gap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The ``K = (max_gap + w) // a + 2`` windows of each clip that can touch
    its gap: ``(xp, mp, starts, pad)``, the zero-padded signal and the
    one-padded mask ``(B, N + 2 pad)`` and the windows' starts in them
    ``(B, K)`` (window k covers ``[k a - w/2, k a + w - w/2)``)."""
    K = (max_gap + w) // a + 2
    half = w // 2
    k0 = torch.div(gap_start + half - w, a, rounding_mode="floor") + 1
    k0 = k0.clamp(min=-(half // a))
    pad = w + a * K + max_gap  # a halo wide enough for every window
    xp = F.pad(x, (pad, pad))
    mp = F.pad(mask, (pad, pad), value=1.0)
    starts = (k0[:, None] + torch.arange(K, device=x.device)) * a - half + pad
    return xp, mp, starts, pad


def overlap_add_update(xp: torch.Tensor, starts: torch.Tensor, solved: torch.Tensor,
                       data: torch.Tensor, gana: torch.Tensor, gsyn: torch.Tensor,
                       a: int) -> torch.Tensor:
    """``xp + sum_k gsyn (solved_k - data_k) / rescale``: the overlap-add of
    the solved windows ``(B, K, w)`` where the untouched windows cancel.
    The windows are added one after another, as the JAX scan adds them."""
    w = gana.shape[-1]
    num = torch.zeros_like(xp)
    s = starts.clamp(0, xp.shape[-1] - w)
    for k in range(starts.shape[1]):
        idx = s[:, k, None] + torch.arange(w, device=xp.device)
        num = num.scatter(-1, idx, num.gather(-1, idx) + gsyn * (solved[:, k] - data[:, k]))
    # sum_k (gana * gsyn)(i - k a) has period a: one period, aligned to the grid.
    taps = -(-w // a)
    profile = F.pad(gana * gsyn, (0, taps * a - w)).view(taps, a).sum(0)
    phase = (torch.arange(xp.shape[-1], device=xp.device) - starts[:, :1]) % a
    power = profile[phase]
    power = torch.where(power > 0, power, 1.0)
    return xp + num / power


def segmentation_inpaint(
    signal: torch.Tensor,
    mask: torch.Tensor,
    gap_start: torch.Tensor,
    gap_len: torch.Tensor,
    p: int = 512,
    maxit: int = 10,
    method: str = "lpc",
    wtype: str = "hann",
    w: int = 4096,
    a: int = 1024,
    max_gap: int = 2048,
) -> torch.Tensor:
    """Windowed-Janssen inpainting of one contiguous gap a clip
    (``segmentation_inp(gapped, p, maxit, 'w', w, 'a', a, 'wtype', wtype)``
    over the gap's neighbourhood).  ``signal``, ``mask``: ``(B, N)``;
    ``gap_start``, ``gap_len``: ``(B,)``.  ``gap_len`` is not read: each
    window's missing run comes from ``mask``."""
    n = signal.shape[-1]
    b = signal.shape[0]
    gana, gsyn = ola_windows(wtype, w, signal.dtype, signal.device)
    x = torch.where(mask > 0, signal, 0.0)
    xp, mp, starts, pad = gap_windows(x, mask, gap_start, w, a, max_gap)
    K = starts.shape[1]
    data = clamped_window(xp, starts, w) * gana  # (B, K, w)
    seg_mask = clamped_window(mp, starts, w)
    miss = seg_mask <= 0
    any_miss = miss.any(-1)
    run_start = miss.to(torch.uint8).argmax(-1)  # the first missing sample (0 if none)
    run_len = miss.sum(-1)
    solved = janssen(data.view(b * K, w), seg_mask.view(b * K, w), run_start.view(-1),
                     run_len.view(-1), p=p, maxit=maxit, method=method,
                     max_gap=max_gap).view(b, K, w)
    solved = torch.where(any_miss[..., None], solved, data)
    return overlap_add_update(xp, starts, solved, data, gana, gsyn, a)[:, pad : pad + n]

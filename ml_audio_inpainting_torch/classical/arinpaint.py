"""Forward/backward LPC extrapolation with a crossfade (port of
``ml_audio_inpainting_tpu/classical/arinpaint.py``).

Fit AR models on the mean-removed pre-gap and (flipped) post-gap context,
extrapolate both into the gap with the pure AR recursion seeded from the
last ``order`` context samples, and blend them.  Both sides of every clip
are one batch of fits and one batch of extrapolations: a step of either
recursion is one set of kernel launches for the whole request.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ml_audio_inpainting_torch.classical._slices import clamped_window, composite_window
from ml_audio_inpainting_torch.ops.linalg import arburg, lpc
from ml_audio_inpainting_torch.utils.precision import full_f32_matmuls

__all__ = ["ar_extrapolate", "arinpaint", "blend_weights"]


def ar_extrapolate(coef: torch.Tensor, context_tail: torch.Tensor, order: int,
                   steps: int) -> torch.Tensor:
    """Continue each row ``steps`` samples past its end by AR recursion,
    ``y[n] = -sum_j a[j] y[n-j]``.

    ``coef``: ``(..., order+1)`` ``[1, a1..ap]``; ``context_tail``: the last
    ``order`` samples ``(..., order)`` (mean-removed).  Returns ``(...,
    steps)``.
    """
    taps = -coef[..., 1 : order + 1].flip(-1)  # taps[j] multiplies the j-th oldest sample
    buf = torch.empty(context_tail.shape[:-1] + (order + steps,), dtype=context_tail.dtype,
                      device=context_tail.device)
    buf[..., :order] = context_tail
    for t in range(steps):
        buf[..., order + t] = (buf[..., t : t + order] * taps).sum(-1)
    return buf[..., order:]


def blend_weights(t: torch.Tensor, blend: str, blend_param: float) -> torch.Tensor:
    """The forward prediction's weight over the gap's relative time ``t`` in
    [0, 1]: ``cos2`` (the reference's crossfade), ``linear`` (a ramp with
    floor ``c = blend_param``) or ``sigmoid`` (steepness ``blend_param``, 2 if
    0)."""
    if blend == "cos2":
        return torch.cos(t * (math.pi / 2)) ** 2
    if blend == "linear":
        c = float(blend_param)
        return c + (1.0 - 2.0 * c) * (1.0 - t)
    if blend == "sigmoid":
        k = float(blend_param) if blend_param else 2.0
        return torch.sigmoid(-k * (t - 0.5))
    raise ValueError(f"unknown blend {blend!r}")


def arinpaint(
    signal: torch.Tensor,
    mask: torch.Tensor,
    gap_start: torch.Tensor,
    gap_len: torch.Tensor,
    order: int = 512,
    context: int = 4096,
    max_gap: int = 2048,
    method: str = "lpc",
    blend: str = "cos2",
    blend_param: float = 0.0,
) -> torch.Tensor:
    """Fill one contiguous gap a clip by bidirectional AR extrapolation.

    ``signal``, ``mask``: ``(B, N)`` (mask 1 = observed); ``gap_start``,
    ``gap_len``: ``(B,)`` integer tensors on the same device.  ``context`` is
    the reference's ``maxlen``: the samples on each side that feed the fit;
    ``max_gap`` the static bound on ``gap_len``.  Context windows and the
    composite clamp their starts into the padded signal as
    ``lax.dynamic_slice`` does.  Returns ``(B, N)`` in ``signal``'s dtype.
    """
    if method not in ("lpc", "arburg"):
        raise ValueError(f"method must be lpc|arburg, got {method!r}")
    n = signal.shape[-1]
    b = signal.shape[0]
    dtype = signal.dtype
    with full_f32_matmuls():
        x = torch.where(mask > 0, signal, 0.0)
        pad = max(context, order + 1)
        xp = F.pad(x, (pad, pad + max_gap))
        pre = clamped_window(xp, gap_start - context + pad, context)
        post = clamped_window(xp, gap_start + gap_len + pad, context).flip(-1)
        sides = torch.cat([pre, post])  # (2B, context): both fits in one batch
        means = sides.mean(-1, keepdim=True)
        sides = sides - means
        fit = lpc if method == "lpc" else arburg
        coef = fit(sides, order)
        ext = ar_extrapolate(coef, sides[..., -order:], order, max_gap) + means
        prediction, postdiction = ext[:b], ext[b:]

        # The backward extrapolation's step k lands on gap position gap_len-1-k.
        idx = torch.arange(max_gap, device=signal.device)
        back = (gap_len[:, None] - 1 - idx).clamp(0, max_gap - 1)
        postdiction = postdiction.gather(-1, back)
        t = (idx.to(dtype) / (gap_len - 1).clamp(min=1).to(dtype)[:, None]).clamp(0.0, 1.0)
        w = blend_weights(t, blend, blend_param)
        fill = w * prediction + (1.0 - w) * postdiction
        return composite_window(x, fill, gap_start, gap_len)

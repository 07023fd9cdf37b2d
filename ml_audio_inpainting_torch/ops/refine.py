"""Waveform-domain gap solvers under a target magnitude (port of
``ml_audio_inpainting_tpu/ops/refine.py``).

:func:`consistent_reconstruct` iterates ``x <- C(iSTFT(P_mag(STFT(x))))``:
``P_mag`` moves the coefficients' magnitude toward the target (optionally
relaxed, on chosen frames), ``C`` puts the observed samples back every
iteration (hard data consistency), which keeps the phase aligned with the
true signal at the gap's edges.  :func:`magnitude_descent` runs Adam on the
gap samples alone, on a magnitude-fit objective with optional AR-residual
and proximal terms; a small step stays in the warm start's basin.

Both are batched over ``(B, S)`` clips on one device, in the inputs' dtype
(f32 or f64; JAX casts the target magnitude to f32, the port to the
inputs' dtype), with no host sync.  Kept as in JAX: the momentum term
subtracts the previous iteration's unaccelerated coefficients (zeros at
first), the magnitude's guard is float32's smallest normal number
(``finfo.tiny``, in f64 too), and the AR residual is a true convolution
(``jnp.convolve(x, a, "valid")``), here ``conv1d`` with the coefficients
flipped, since ``conv1d`` correlates.  The gradient is ``torch.autograd``
through the STFT.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ml_audio_inpainting_torch.ops.stft import istft, stft

__all__ = ["consistent_reconstruct", "magnitude_descent"]


def consistent_reconstruct(
    mag: torch.Tensor,
    observed: torch.Tensor,
    sample_valid: torch.Tensor,
    init_x: torch.Tensor,
    n_iter: int = 100,
    mag_frames: Optional[torch.Tensor] = None,
    beta: float = 1.0,
    momentum: float = 0.0,
    n_fft: Optional[int] = None,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Solve the gap waveform under a target magnitude.

    ``mag`` ``(B, F, N)`` is the target linear magnitude; ``observed``
    ``(B, S)`` the gapped waveform; ``sample_valid`` ``(B, S)`` 1 = observed;
    ``init_x`` ``(B, S)`` the warm start (an AR fill or an extrapolated-phase
    reconstruction); ``mag_frames`` ``(B, N)`` 1 = impose the target on
    this frame (None: all frames), other frames keep their current
    magnitude; the imposed magnitude is ``beta * mag + (1 - beta) * |X|``;
    ``momentum`` in [0, 1) is fast Griffin-Lim's.  Returns ``(B, length)``
    (``length`` defaults to ``S``); observed samples pass through exactly.
    """
    if momentum < 0 or momentum >= 1:
        raise ValueError(f"momentum must be in [0, 1), got {momentum}")
    if not 0.0 <= beta <= 1.0:
        raise ValueError(f"beta must be in [0, 1], got {beta}")
    s = observed.shape[-1]
    length = s if length is None else length
    kw = dict(n_fft=n_fft, hop_length=hop_length, win_length=win_length)
    dtype = observed.dtype
    mag = mag.to(dtype)
    if mag_frames is not None:
        w_frame = (beta * mag_frames.to(dtype))[:, None, :]
    else:
        w_frame = torch.full((1, 1, 1), beta, dtype=dtype, device=observed.device)
    eps = torch.finfo(torch.float32).tiny
    hole = 1.0 - sample_valid
    x = sample_valid * observed + hole * init_x
    prev = torch.zeros_like(stft(x, **kw))
    for _ in range(n_iter):
        spec = stft(x, **kw)
        acc = spec - (momentum / (1 + momentum)) * prev if momentum > 0 else spec
        cur = acc.abs()
        target = w_frame * mag + (1.0 - w_frame) * cur
        y = istft(acc / (cur + eps) * target, length=s, **kw)
        x = sample_valid * observed + hole * y
        prev = spec
    return x[..., :length]


def magnitude_descent(
    mag: torch.Tensor,
    observed: torch.Tensor,
    sample_valid: torch.Tensor,
    init_x: torch.Tensor,
    ar_coef: Optional[torch.Tensor] = None,
    n_steps: int = 50,
    lr: float = 0.05,
    mag_weight: float = 1.0,
    ar_weight: float = 0.0,
    prox_weight: float = 0.0,
    mag_frames: Optional[torch.Tensor] = None,
    log_domain: bool = True,
    n_fft: Optional[int] = None,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
) -> torch.Tensor:
    """Refine the gap samples by Adam (``lr``, betas 0.9/0.999, eps 1e-8,
    bias-corrected at step ``t = i + 1``) on

        J(g) = mag_weight * mean(w_f (|STFT(x)| - M)^2)   (log1p of both
                                                         when log_domain)
             + ar_weight * mean((a * x)^2)               (AR residual)
             + prox_weight * mean(hole (g - g_init)^2)

    over the gap samples ``g`` of ``x = observed`` outside the gap.  Inputs
    as :func:`consistent_reconstruct`'s; ``ar_coef`` ``(B, p + 1)`` are the
    error filters ``[1, a1..ap]`` (required when ``ar_weight > 0``) and
    ``mag_frames`` weights the frames.  Returns the refined ``(B, S)``;
    observed samples pass through exactly.
    """
    kw = dict(n_fft=n_fft, hop_length=hop_length, win_length=win_length)
    dtype = observed.dtype
    mag = mag.to(dtype)
    target = torch.log1p(mag) if log_domain else mag
    w_f = mag_frames.to(dtype)[:, None, :] if mag_frames is not None else 1.0
    hole = 1.0 - sample_valid
    g0 = hole * init_x
    fixed = sample_valid * observed
    if ar_weight > 0:
        if ar_coef is None:
            raise ValueError("ar_weight > 0 needs ar_coef")
        b = ar_coef.shape[0]
        flipped = ar_coef.to(dtype).flip(-1)[:, None, :]  # (B, 1, p+1): conv1d correlates

    def loss_fn(g: torch.Tensor) -> torch.Tensor:
        x = fixed + hole * g
        total = torch.zeros((), dtype=dtype, device=observed.device)
        if mag_weight > 0:
            cur = stft(x, **kw).abs()
            cur = torch.log1p(cur) if log_domain else cur
            total = total + mag_weight * torch.mean(w_f * (cur - target) ** 2)
        if ar_weight > 0:
            resid = F.conv1d(x[None], flipped, groups=b)[0]  # (B, S - p), "valid"
            total = total + ar_weight * torch.mean(resid**2)
        if prox_weight > 0:
            total = total + prox_weight * torch.mean(hole * (g - g0) ** 2)
        return total

    b1, b2, eps = 0.9, 0.999, 1e-8
    g = g0.clone()
    m = torch.zeros_like(g0)
    v = torch.zeros_like(g0)
    for i in range(n_steps):
        with torch.enable_grad():
            gv = g.detach().requires_grad_(True)
            grads = torch.autograd.grad(loss_fn(gv), gv)[0] * hole
        m = b1 * m + (1 - b1) * grads
        v = b2 * v + (1 - b2) * grads**2
        t = i + 1
        mh = m / (1 - b1**t)
        vh = v / (1 - b2**t)
        g = g - lr * mh / (torch.sqrt(vh) + eps)
    return fixed + hole * g

"""Learned-basis SPAIN: a unitary sparsifying basis and SPAIN on its STFT
coefficients (port of ``ml_audio_inpainting_tpu/classical/basisopt.py``).

* :func:`optimize_basis` (``basis_opt_new.m``): a unitary ``B`` that lowers
  ``||B X_tr||_1``, composed from matrix exponentials ``expm(j 2 pi A)`` of
  banded Hermitian ``A`` (real diagonal, one complex off-diagonal), each
  found by Adam (optax's rule) on ``sum|Y + j 2 pi A Y|`` under the clamp
  ``|A| <= level``, with the same trust-region shrink loop as the JAX
  package.  It is an offline tool: its loop reads its progress on the host.
* :func:`aspain_learned`, :func:`sspain_learned` (``a_spain_learned.m``,
  ``s_spain_learned.m``): the SPAIN loops on ``B @ stft(x)``, keeping the
  ``k`` largest coefficients of each column (DC and last rows weighted
  1/sqrt(2) for the ranking).  The identity basis gives plain per-column
  SPAIN.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ml_audio_inpainting_torch.classical.spain import _freeze, _keep_best, per_row
from ml_audio_inpainting_torch.ops.stft import istft, stft
from ml_audio_inpainting_torch.utils.precision import full_f32_matmuls

__all__ = [
    "optimize_basis",
    "hard_threshold_columns",
    "aspain_learned",
    "sspain_learned",
]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def _banded_hermitian(diag: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Hermitian matrix with real diagonal ``diag (N,)`` and complex first
    off-diagonal ``off (N-1,)``."""
    return (torch.diag(diag.to(off.dtype)) + torch.diag(off, 1)
            + torch.diag(off.conj(), -1))


def _clip(x: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """``jnp.clip``: its gradient is 1/2 where ``x`` equals a bound, as
    ``torch.maximum``/``minimum`` give it (``clamp`` would give 1)."""
    return torch.minimum(torch.maximum(x, -level), level)


def optimize_basis(
    X_tr: torch.Tensor,
    level_init: float = 1e-2,
    epsilon: float = 1e-4,
    inner_steps: int = 200,
    inner_lr: float = 1e-3,
    max_outer: int = 20,
    seed: int = 0,
) -> Tuple[torch.Tensor, float, float]:
    """Optimise a unitary sparsifying basis for the columns of ``X_tr (N,
    M)``, on ``X_tr``'s device, in complex64.  Returns ``(basis,
    sparsity_init, sparsity_final)`` like ``basis_opt_new.m``.  ``seed`` is
    unused, as in the JAX package (the subproblems start from zero)."""
    del seed
    N = X_tr.shape[0]
    device = X_tr.device
    X_tr = X_tr.to(torch.complex64)
    B = torch.eye(N, dtype=torch.complex64, device=device)
    sparsity_init = float(X_tr.abs().sum())
    sparsity = sparsity_init
    sparsity_old = math.inf
    level = level_init
    cnt = 0

    def subproblem_loss(params, Y, lvl):
        d, o_r, o_i = (_clip(v, lvl) for v in params)
        A = _banded_hermitian(d, torch.complex(o_r, o_i))
        return (Y + 2j * math.pi * (A @ Y)).abs().sum()

    with full_f32_matmuls():
        while level > epsilon and cnt < max_outer:
            improved_any = False
            while sparsity < sparsity_old and cnt < max_outer:
                Y = B @ X_tr
                lvl = torch.full((), level, device=device)
                params = [torch.zeros(N, device=device), torch.zeros(N - 1, device=device),
                          torch.zeros(N - 1, device=device)]
                mu = [torch.zeros_like(v) for v in params]
                nu = [torch.zeros_like(v) for v in params]
                for step in range(1, inner_steps + 1):
                    leaves = [v.requires_grad_() for v in params]
                    grads = torch.autograd.grad(subproblem_loss(leaves, Y, lvl), leaves)
                    # optax's bias corrections, in f32
                    c1 = 1 - torch.full((), ADAM_B1, device=device) ** step
                    c2 = 1 - torch.full((), ADAM_B2, device=device) ** step
                    new = []
                    for i, (v, g) in enumerate(zip(params, grads)):
                        mu[i] = (1 - ADAM_B1) * g + ADAM_B1 * mu[i]
                        nu[i] = (1 - ADAM_B2) * g * g + ADAM_B2 * nu[i]
                        update = (mu[i] / c1) / (torch.sqrt(nu[i] / c2) + ADAM_EPS)
                        new.append((v.detach() - inner_lr * update).clamp(-level, level))
                    params = new
                A = _banded_hermitian(params[0], torch.complex(params[1], params[2]))
                B_new = torch.linalg.matrix_exp(2j * math.pi * A) @ B
                new_sparsity = float((B_new @ X_tr).abs().sum())
                cnt += 1
                if new_sparsity < sparsity:
                    sparsity_old = sparsity
                    B = B_new
                    sparsity = new_sparsity
                    improved_any = True
                else:
                    break
            level = level / 2
            if improved_any:
                sparsity_old = math.inf  # allow further descent at the finer level
        sparsity_final = float((B @ X_tr).abs().sum())
    return B, sparsity_init, sparsity_final


def hard_threshold_columns(C: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Keep the ``k`` largest entries of each column of ``C (..., F, cols)``
    (``k``: an int or a ``(...)`` integer tensor), ranking with the first and last rows
    weighted 1/sqrt(2) (``hard_thresholding_dgtreal.m:1-25``)."""
    F_ = C.shape[-2]
    real = C.real.dtype
    weights = torch.ones(F_, 1, dtype=real, device=C.device)
    weights[0] = weights[-1] = 1 / math.sqrt(2.0)
    mags = C.abs() * weights
    ordered = mags.sort(dim=-2, descending=True, stable=True).values
    kc = (per_row(k, C.shape[:-2], C.device).clamp(1, F_) - 1)[..., None, None]
    kc = kc.expand(C.shape[:-2] + (1, C.shape[-1]))
    thresh = ordered.gather(-2, kc)
    return torch.where(mags >= thresh.clamp(min=1e-30), C, 0.0)


def _learned_frame(basis, n, n_fft, hop_length, win_length, complex_dtype):
    """(analysis, synthesis) of the learned frame: ``B @ stft(x)`` and
    ``istft(Bᴴ z)``."""
    basis = basis.to(complex_dtype)
    basis_h = basis.conj().mT

    def ana(x):
        return basis @ stft(x, n_fft=n_fft, hop_length=hop_length, win_length=win_length)

    def syn(z):
        return istft(basis_h @ z, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
                     length=n)

    return ana, syn


def _complex_of(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def aspain_learned(gapped: torch.Tensor, mask: torch.Tensor, basis: torch.Tensor,
                   maxit: int = 100, s: int = 1, r: int = 1, epsilon: float = 1e-3,
                   n_fft: int = 512, hop_length: int = 128, win_length: int = 512) -> torch.Tensor:
    """A-SPAIN over learned-basis STFT coefficients (``a_spain_learned.m``)
    of each row of ``gapped (..., n)``; ``mask`` 1 = reliable; ``basis``:
    unitary ``(F, F)``."""
    batch, n = gapped.shape[:-1], gapped.shape[-1]
    ana, syn = _learned_frame(basis, n, n_fft, hop_length, win_length, _complex_of(gapped.dtype))
    with full_f32_matmuls():
        x0 = torch.where(mask > 0, gapped, 0.0)
        x_hat, z_est = x0, ana(x0)
        u = torch.zeros_like(z_est)
        k = torch.full(batch, s, dtype=torch.int64, device=gapped.device)
        best = x0
        best_obj = torch.full(batch, math.inf, dtype=gapped.dtype, device=gapped.device)
        done = torch.zeros(batch, dtype=torch.bool, device=gapped.device)
        for it in range(maxit):
            z_bar = hard_threshold_columns(z_est + u, k)
            obj = torch.linalg.vector_norm(z_est - z_bar, dim=(-2, -1))
            best, best_obj, done = _keep_best(obj, x_hat, best, best_obj, done, epsilon)
            x_new = torch.where(mask > 0, x0, syn(z_bar - u))
            z_new = ana(x_new)
            u_new = u + z_new - z_bar
            k_new = k + s if (it + 2) % r == 0 else k
            x_hat = _freeze(done, x_hat, x_new)
            z_est = _freeze(done, z_est, z_new)
            u = _freeze(done, u, u_new)
            k = torch.where(done, k, k_new)
        return best


def sspain_learned(gapped: torch.Tensor, mask: torch.Tensor, basis: torch.Tensor,
                   maxit: int = 100, s: int = 1, r: int = 1, epsilon: float = 1e-3,
                   n_fft: int = 512, hop_length: int = 128, win_length: int = 512) -> torch.Tensor:
    """S-SPAIN over learned-basis STFT coefficients (``s_spain_learned.m``,
    H f-update) of each row of ``gapped (..., n)``."""
    batch, n = gapped.shape[:-1], gapped.shape[-1]
    ana, syn = _learned_frame(basis, n, n_fft, hop_length, win_length, _complex_of(gapped.dtype))
    with full_f32_matmuls():
        x0 = torch.where(mask > 0, gapped, 0.0)
        x_hat, u = x0, torch.zeros_like(x0)
        k = torch.full(batch, s, dtype=torch.int64, device=gapped.device)
        best = x0
        best_obj = torch.full(batch, math.inf, dtype=gapped.dtype, device=gapped.device)
        done = torch.zeros(batch, dtype=torch.bool, device=gapped.device)
        for it in range(maxit):
            x_est = syn(hard_threshold_columns(ana(x_hat - u), k))
            obj = torch.linalg.vector_norm(x_est - x_hat, dim=-1)
            best, best_obj, done = _keep_best(obj, x_hat, best, best_obj, done, epsilon)
            x_new = torch.where(mask > 0, x0, x_est + u)
            u_new = u + x_est - x_new
            k_new = k + s if (it + 2) % r == 0 else k
            x_hat = _freeze(done, x_hat, x_new)
            u = _freeze(done, u, u_new)
            k = torch.where(done, k, k_new)
        return best

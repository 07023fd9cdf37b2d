"""AR model estimation and the banded Cholesky solve (port of
``ml_audio_inpainting_tpu/ops/linalg.py``).

MATLAB's ``lpc`` (autocorrelation + Levinson-Durbin) and ``arburg`` as used
by the classical solvers, and the block-tridiagonal Cholesky solve of the
long-gap Janssen system.  Every function takes a batch in its leading
dimensions: one fit a row, all rows advanced together at each step of the
recursion, so a step costs one set of kernel launches for the whole batch.
The recursions are Python loops over a static order ``p`` (the JAX package's
``fori_loop``/``scan``), in the dtype of the input (f32 or f64).

A failed block factorisation is reported through ``cholesky_ex``'s ``info``
on the device (no host sync), and the JAX package's rule is kept: the solve
then runs with identity factors and the caller acts on ``ok``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "autocorrelation",
    "levinson",
    "lpc",
    "arburg",
    "ar_coef_autocorr",
    "block_tridiag_cholesky_solve",
    "cholesky",
]


def autocorrelation(x: torch.Tensor, maxlag: int) -> torch.Tensor:
    """Biased autocorrelation ``r[0..maxlag]`` of ``(..., N)`` via FFT
    (MATLAB ``xcorr(x, 'biased')``: divided by N)."""
    n = x.shape[-1]
    nfft = 1
    while nfft < 2 * n:
        nfft *= 2
    X = torch.fft.rfft(x, n=nfft)
    r = torch.fft.irfft(X * X.conj(), n=nfft)[..., : maxlag + 1]
    return r / n


def levinson(r: torch.Tensor, p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Levinson-Durbin recursion on autocorrelations ``r (..., >= p+1)``.

    Returns ``(a, e)``: ``a = [1, a1..ap]`` ``(..., p+1)`` (error-filter
    convention, as MATLAB ``lpc``) and the final prediction error ``(...)``.
    """
    a = torch.zeros(r.shape[:-1] + (p + 1,), dtype=r.dtype, device=r.device)
    a[..., 0] = 1.0
    e = r[..., 0]
    rf = r[..., : p + 1].flip(-1)  # rf[i] = r[p - i]
    for m in range(1, p + 1):
        # acc = sum_{j<m} a[j] r[m-j]
        acc = (a[..., :m] * rf[..., p - m : p]).sum(-1)
        k = torch.where(e == 0, 0.0, -acc / e)
        if m > 1:  # a[j] += k a[m-j], j = 1..m-1
            a[..., 1:m] += k[..., None] * a[..., 1:m].flip(-1)
        a[..., m] = k
        e = e * (1.0 - k * k)
    return a, e


def lpc(x: torch.Tensor, p: int) -> torch.Tensor:
    """Linear-prediction coefficients ``[1, a1..ap]`` of each row of
    ``(..., N)`` (MATLAB ``lpc``)."""
    return levinson(autocorrelation(x, p), p)[0]


def arburg(x: torch.Tensor, p: int) -> torch.Tensor:
    """Burg-method AR coefficients ``[1, a1..ap]`` of each row of ``(..., N)``
    (MATLAB ``arburg``): at step m the forward error drops its head and the
    backward error its tail, so both shrink to ``N - m`` samples."""
    a = torch.zeros(x.shape[:-1] + (p + 1,), dtype=x.dtype, device=x.device)
    a[..., 0] = 1.0
    ef = eb = x
    for m in range(1, p + 1):
        efp, ebp = ef[..., 1:], eb[..., :-1]
        num = -2.0 * (efp * ebp).sum(-1)
        den = (efp * efp).sum(-1) + (ebp * ebp).sum(-1)
        k = torch.where(den == 0, 0.0, num / den)
        ef = efp + k[..., None] * ebp
        eb = ebp + k[..., None] * efp
        a[..., 1 : m + 1] += k[..., None] * a[..., :m].flip(-1)
    return a


def ar_coef_autocorr(coef: torch.Tensor, p: int) -> torch.Tensor:
    """``b[k] = sum_j coef[j] coef[j+k]`` for ``k = 0..p`` of ``(..., p+1)``:
    the banded normal-equation generator of the Janssen solver, as one
    batched product with the shifted copies of ``coef``."""
    shifted = F.pad(coef, (0, p)).unfold(-1, p + 1, 1)  # [..., k, j] = coef[j + k] or 0
    return torch.matmul(shifted, coef[..., None])[..., 0]


def cholesky(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower Cholesky factor of the symmetrised ``(a + aᵀ) / 2`` (as
    ``jnp.linalg.cholesky`` factors) and a ``(...)`` bool that is True where
    the factorisation succeeded, both on the device (no host sync)."""
    L, info = torch.linalg.cholesky_ex((a + a.mT) / 2)
    return L, info == 0


def block_tridiag_cholesky_solve(
    D: torch.Tensor, E: torch.Tensor, rhs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve ``A x = rhs`` for SPD block-tridiagonal ``A``, batched.

    ``D``: ``(..., nb, q, q)`` diagonal blocks; ``E``: ``(..., nb, q, q)``
    sub-diagonal blocks, ``E[k] = A[(k+1)q:(k+2)q, kq:(k+1)q]`` (``E[nb-1]``
    unused); ``rhs``: ``(..., nb * q)``.  The factor is block-bidiagonal:
    one ``(q, q)`` Cholesky, triangular solve and product a block, then a
    forward and a backward block sweep.

    Returns ``(x, ok)``: ``(..., nb * q)`` and a ``(...)`` bool, False where a
    block factorisation failed or left non-finite values; there the solve
    runs with identity factors (the JAX package's rule).
    """
    nb, q = D.shape[-3], D.shape[-1]
    eye = torch.eye(q, dtype=D.dtype, device=D.device)
    Ls, Cs, ok = [], [], None
    for k in range(nb):
        Dk = D[..., k, :, :]
        if k == 0:  # nothing above the first block
            C = torch.zeros_like(Dk)
            S = Dk
        else:
            C = torch.linalg.solve_triangular(Ls[-1], E[..., k - 1, :, :].mT, upper=False).mT
            S = Dk - C @ C.mT
        L, good = cholesky(S)
        ok = good if ok is None else ok & good
        Ls.append(L)
        Cs.append(C)
    Ls = torch.stack(Ls, -3)
    Cs = torch.stack(Cs, -3)
    ok = ok & torch.isfinite(Ls).flatten(-3).all(-1) & torch.isfinite(Cs).flatten(-3).all(-1)
    Ls = torch.where(ok[..., None, None, None], Ls, eye)
    Cs = torch.where(ok[..., None, None, None], Cs, 0.0)

    r = rhs.unflatten(-1, (nb, q))[..., None]  # (..., nb, q, 1)
    ys = []
    for k in range(nb):
        rk = r[..., k, :, :] if k == 0 else r[..., k, :, :] - Cs[..., k, :, :] @ ys[-1]
        ys.append(torch.linalg.solve_triangular(Ls[..., k, :, :], rk, upper=False))
    xs = [None] * nb
    for k in reversed(range(nb)):
        yk = ys[k] if k == nb - 1 else ys[k] - Cs[..., k + 1, :, :].mT @ xs[k + 1]
        xs[k] = torch.linalg.solve_triangular(Ls[..., k, :, :].mT, yk, upper=True)
    return torch.cat(xs, -2)[..., 0], ok

"""Janssen iterative AR inpainting (port of
``ml_audio_inpainting_tpu/classical/janssen.py``).

Each iteration fits an AR(p) model to the current solution (lpc or Burg),
builds the normal equations of the missing samples from the coefficients'
autocorrelation ``b``, and solves them by Cholesky: a dense ``(max_gap,
max_gap)`` system, or block-tridiagonal with blocks of ``p`` (the system's
bandwidth).  The observed side ``AA(:, indobs) @ x_obs`` is a correlation of
the masked signal with ``b[|k|]``, taken only at the ``max_gap`` rows the
solve reads, as one batched product.

A clip whose Cholesky fails keeps its last solution from then on (the
reference's bail-out, ``janssen_inp.m:108-111``): ``cholesky_ex`` reports the
failure on the device and a ``where`` freezes that clip, with no host sync.
The solvers run with full-f32 matrix products (TF32 off) in a local scope:
Janssen needs them (the JAX package forces ``highest`` precision here).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ml_audio_inpainting_torch.classical._slices import (
    clamped_starts,
    clamped_window,
    composite_window,
)
from ml_audio_inpainting_torch.ops.linalg import (
    ar_coef_autocorr,
    arburg,
    block_tridiag_cholesky_solve,
    cholesky,
    lpc,
)
from ml_audio_inpainting_torch.utils.precision import full_f32_matmuls

__all__ = ["janssen", "janssen_gapwise", "use_banded_solver"]


def use_banded_solver(solver: str, p: int, max_gap: int) -> bool:
    """Whether ``solver`` ("auto", "dense" or "banded") runs the banded form:
    "auto" picks it when blocks of ``p`` tile ``max_gap`` at least twice."""
    if solver not in ("auto", "dense", "banded"):
        raise ValueError(f"solver must be auto|dense|banded, got {solver!r}")
    banded = solver == "banded" or (solver == "auto" and max_gap % p == 0 and max_gap // p >= 2)
    if banded and max_gap % p != 0:
        raise ValueError(f"banded solver needs max_gap % p == 0 ({max_gap} % {p})")
    return banded


def _observed_rows(obs: torch.Tensor, b: torch.Tensor, p: int, start: torch.Tensor,
                   rows: int) -> torch.Tensor:
    """``g[i] = sum_{|k|<=p} b[|k|] obs[i+k]`` at ``i = start .. start+rows-1``
    (0 past the signal's end, as the JAX solver pads ``g``); ``start`` is
    already clamped to ``[0, N]``."""
    n = obs.shape[-1]
    kernel = torch.cat([b.flip(-1), b[:, 1:]], -1)  # b[|k|], k = -p..p
    padded = F.pad(obs, (p, p + rows))
    local = clamped_window(padded, start, rows + 2 * p)  # start is in range: no clamping
    g = torch.matmul(local.unfold(-1, 2 * p + 1, 1), kernel[:, :, None])[..., 0]
    inside = (start[:, None] + torch.arange(rows, device=obs.device)) < n
    return torch.where(inside, g, 0.0)


def janssen(
    signal: torch.Tensor,
    mask: torch.Tensor,
    gap_start: torch.Tensor,
    gap_len: torch.Tensor,
    p: int = 512,
    maxit: int = 10,
    method: str = "lpc",
    max_gap: int = 2048,
    saveall: bool = False,
    ridge: float = 1e-6,
    solver: str = "auto",
) -> torch.Tensor:
    """Inpaint one contiguous gap in each row of ``signal (B, N)``.

    ``mask``: ``(B, N)``, 1 = observed (the gap's values are ignored);
    ``gap_start``, ``gap_len``: ``(B,)`` integer tensors.  ``p``: AR order;
    ``maxit``: iterations; ``method``: "lpc" | "arburg"; ``max_gap``: static
    bound on the gap (rows past ``gap_len`` are identity); ``ridge``:
    relative diagonal loading (0 for the reference's strict semantics);
    ``solver``: see :func:`use_banded_solver`.  Returns ``(B, N)``, or with
    ``saveall`` every iteration's solution ``(B, maxit, N)``; the observed
    samples are untouched.
    """
    if method not in ("lpc", "arburg"):
        raise ValueError(f"method must be lpc|arburg, got {method!r}")
    banded = use_banded_solver(solver, p, max_gap)
    n = signal.shape[-1]
    dtype, device = signal.dtype, signal.device
    with full_f32_matmuls():
        solution = torch.where(mask > 0, signal, 0.0)
        i_idx = torch.arange(max_gap, device=device)
        in_gap = i_idx < gap_len[:, None]  # (B, max_gap)
        start = clamped_starts(gap_start, n + max_gap, max_gap)
        gl = gap_len[:, None, None, None]
        if banded:
            q = p
            nb = max_gap // q
            li = torch.arange(q, device=device)[:, None]
            lj = torch.arange(q, device=device)[None, :]
            blk = torch.arange(nb, device=device)[:, None, None]
            dist_D = (li - lj).abs()
            dist_E = q + li - lj  # E[k] couples rows (k+1)q + li to columns kq + lj
            in_D = ((blk * q + li) < gl) & ((blk * q + lj) < gl)  # (B, nb, q, q)
            in_E = (((blk + 1) * q + li) < gl) & ((blk * q + lj) < gl)
            eye = torch.eye(q, dtype=dtype, device=device)
        else:
            dist = (i_idx[:, None] - i_idx[None, :]).abs()
            eye = torch.eye(max_gap, dtype=dtype, device=device)
        failed = torch.zeros(signal.shape[0], dtype=torch.bool, device=device)
        history = []
        fit = lpc if method == "lpc" else arburg
        for _ in range(maxit):
            b = ar_coef_autocorr(fit(solution, p), p)  # (B, p+1)
            obs = torch.where(mask > 0, solution, 0.0)
            rhs = torch.where(in_gap, -_observed_rows(obs, b, p, start, max_gap), 0.0)
            loading = (ridge * b[:, 0])[:, None, None] * eye if ridge > 0 else None
            if banded:
                band_D = torch.where(dist_D <= p, b[:, dist_D.clamp(0, p)], 0.0)
                D = torch.where(in_D, band_D[:, None], eye)
                if loading is not None:
                    D = D + loading[:, None]
                band_E = torch.where(dist_E <= p, b[:, dist_E.clamp(0, p)], 0.0)
                E = torch.where(in_E, band_E[:, None], 0.0)
                x_miss, ok = block_tridiag_cholesky_solve(D, E, rhs)
            else:
                band = torch.where(dist <= p, b[:, dist.clamp(0, p)], 0.0)
                A = torch.where(in_gap[:, :, None] & in_gap[:, None, :], band, eye)
                if loading is not None:
                    A = A + loading
                L, ok = cholesky(A)
                ok = ok & torch.isfinite(L).flatten(-2).all(-1)
                L = torch.where(ok[:, None, None], L, eye)
                y = torch.linalg.solve_triangular(L, rhs[:, :, None], upper=False)
                x_miss = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
            x_miss = torch.where(in_gap, x_miss, 0.0)
            failed = failed | ~ok
            updated = composite_window(solution, x_miss, gap_start, gap_len)
            solution = torch.where(failed[:, None], solution, updated)
            if saveall:
                history.append(solution)
    return torch.stack(history, 1) if saveall else solution


def janssen_gapwise(
    signal: torch.Tensor,
    mask: torch.Tensor,
    gap_start: torch.Tensor,
    gap_len: torch.Tensor,
    p: int = 512,
    maxit: int = 10,
    method: str = "lpc",
    max_gap: int = 2048,
    context: int = 4096,
    ridge: float = 1e-6,
    solver: str = "auto",
) -> torch.Tensor:
    """Janssen on the ``gap +- context`` segment of each clip only, as the
    reference benchmark calls it (``train.m:131-142``): the AR model is fit
    on the gap's neighbourhood.  Shapes as :func:`janssen`; samples outside
    the gap are returned as given."""
    n = signal.shape[-1]
    seg_len = 2 * context + max_gap
    pad = context + max_gap
    xp = F.pad(torch.where(mask > 0, signal, 0.0), (pad, pad))
    mp = F.pad(mask, (pad, pad), value=1.0)
    seg_start = clamped_starts(gap_start - context + pad, xp.shape[-1], seg_len)
    idx = seg_start[:, None] + torch.arange(seg_len, device=signal.device)
    solved = janssen(xp.gather(-1, idx), mp.gather(-1, idx), torch.full_like(gap_start, context),
                     gap_len, p=p, maxit=maxit, method=method, max_gap=max_gap, ridge=ridge,
                     solver=solver)
    out = xp.scatter(-1, idx, solved)[:, pad : pad + n]
    return torch.where(mask > 0, signal, out)

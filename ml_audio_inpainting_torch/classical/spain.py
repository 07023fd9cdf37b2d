"""SPAIN (SParse Audio INpainter): A-SPAIN and S-SPAIN on the DFT frame (port
of ``ml_audio_inpainting_tpu/classical/spain.py``).

ADMM-style loops alternate hard thresholding in a DFT frame with a
time-domain consistency projection and a dual update; the sparsity ``k``
grows by ``s`` every ``r`` iterations (``aspain.m:42-97``,
``sspain.m:44-100``), run on each overlap-add window the gap touches
(``spain_segmentation.m``).

* The frame is the unitary FFT pair ``fft(x)/sqrt(w)``, ``ifft(z)*sqrt(w)``.
* Hard thresholding ranks the half spectrum (DC halved), keeps every
  coefficient at least as large as the ``k``-th largest, and mirrors the
  conjugate pairs.  Ties at the threshold are all kept, so which of two tied
  elements a sort puts first does not change the result.
* Every window of every clip carries its own ``k``, best iterate and
  early-stop flag: the loop runs its full length and a window that has
  converged stops changing, as in the JAX package's ``scan``.
* S-SPAIN's OMP f-update selects conjugate atom pairs of an oversampled DFT
  dictionary greedily and re-fits them by least squares.
"""

from __future__ import annotations

import math

import torch

from ml_audio_inpainting_torch.classical.ola import gap_windows, ola_windows, overlap_add_update
from ml_audio_inpainting_torch.classical._slices import clamped_window
from ml_audio_inpainting_torch.ops.linalg import cholesky
from ml_audio_inpainting_torch.utils.precision import full_f32_matmuls

__all__ = [
    "hard_threshold_dft",
    "omp_approximation",
    "aspain_core",
    "sspain_core",
    "spain_inpaint",
]


def _frana(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft(x) / math.sqrt(x.shape[-1])


def _frsyn(z: torch.Tensor) -> torch.Tensor:
    return (torch.fft.ifft(z) * math.sqrt(z.shape[-1])).real


def per_row(k, shape, device) -> torch.Tensor:
    """``k`` (an int, or an integer tensor broadcastable to ``shape``) as an
    int64 tensor of ``shape`` on ``device``."""
    if isinstance(k, torch.Tensor):
        return k.expand(shape)
    return torch.full(shape, k, dtype=torch.int64, device=device)


def _kept(mags: torch.Tensor, k) -> torch.Tensor:
    """``mags >=`` the ``k``-th largest of each row of ``mags (..., m)``
    (``k`` clamped to ``[1, m]``)."""
    size = mags.shape[-1]
    ordered = mags.sort(dim=-1, descending=True, stable=True).values
    kc = per_row(k, mags.shape[:-1], mags.device).clamp(1, size) - 1
    return mags >= ordered.gather(-1, kc[..., None])


def hard_threshold_dft(z: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Keep the ``k`` largest half-spectrum coefficients of each row of
    ``z (..., w)`` (conjugate pairs counted once, DC halved for the ranking);
    ``k``: an int or a ``(...)`` integer tensor (``hard_thresholding.m:1-33``)."""
    w = z.shape[-1]
    nhalf = w // 2 + 1
    half = torch.cat([z[..., :1] * 0.5, z[..., 1:nhalf]], -1)
    s = torch.where(_kept(half.abs(), k), half, 0.0)
    s = torch.cat([s[..., :1] * 2.0, s[..., 1:]], -1)
    mirror = (s[..., 1:-1] if w % 2 == 0 else s[..., 1:]).flip(-1).conj()
    return torch.cat([s, mirror], -1)


def _freeze(done: torch.Tensor, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    return torch.where(done.view(done.shape + (1,) * (new.dim() - done.dim())), old, new)


def _keep_best(obj, x_hat, best, best_obj, done, epsilon):
    improved = (obj <= best_obj) & ~done
    best = _freeze(improved, x_hat, best)  # where improved: x_hat
    best_obj = torch.where(improved, obj, best_obj)
    return best, best_obj, done | (obj <= epsilon)


def aspain_core(gapped: torch.Tensor, mask: torch.Tensor, maxit: int = 100, s: int = 1,
                r: int = 1, epsilon: float = 1e-3) -> torch.Tensor:
    """A-SPAIN on each row of ``(..., w)`` (``aspain.m:42-97``): ``gapped``
    already analysis-windowed, ``mask`` 1 = reliable.  Returns the best
    iterate of each row."""
    with full_f32_matmuls():
        batch = gapped.shape[:-1]
        x0 = torch.where(mask > 0, gapped, 0.0)
        x_hat, z_est = x0, _frana(x0)
        u = torch.zeros_like(z_est)
        k = torch.full(batch, s, dtype=torch.int64, device=gapped.device)
        best = x0
        best_obj = torch.full(batch, math.inf, dtype=gapped.dtype, device=gapped.device)
        done = torch.zeros(batch, dtype=torch.bool, device=gapped.device)
        for it in range(maxit):
            z_bar = hard_threshold_dft(z_est + u, k)
            obj = torch.linalg.vector_norm(z_est - z_bar, dim=-1)
            best, best_obj, done = _keep_best(obj, x_hat, best, best_obj, done, epsilon)
            x_new = torch.where(mask > 0, x0, _frsyn(z_bar - u))
            z_new = _frana(x_new)
            u_new = u + z_new - z_bar
            k_new = k + s if (it + 2) % r == 0 else k
            x_hat = _freeze(done, x_hat, x_new)
            z_est = _freeze(done, z_est, z_new)
            u = _freeze(done, u, u_new)
            k = torch.where(done, k, k_new)
        return best


def omp_approximation(sdata: torch.Tensor, k: torch.Tensor, max_k: int,
                      redundancy: int = 2) -> torch.Tensor:
    """Orthogonal matching pursuit over the oversampled DFT pair dictionary
    ``{cos(2 pi j n / M), sin(2 pi j n / M)}``, ``M = redundancy * w``, of
    each row of ``sdata (..., w)``: ``min(k, max_k)`` greedy selections,
    each followed by the least-squares re-fit of every selected pair (a
    ``(2 max_k, 2 max_k)`` Cholesky solve, identity on empty and zero-norm
    slots).  ``k``: ``(...)`` integer.  Returns the LS approximation.

    A slot's atoms are computed once, when the slot is filled: they are the
    same values the JAX package recomputes from the selection at each step.
    """
    w = sdata.shape[-1]
    M = redundancy * w
    nhalf = M // 2 + 1
    batch = sdata.shape[:-1]
    dtype, device = sdata.dtype, sdata.device
    n = torch.arange(w, dtype=dtype, device=device)
    kc = per_row(k, batch, device).clamp(1, max_k)
    eye2k = torch.eye(2 * max_k, dtype=dtype, device=device)
    atoms = torch.zeros(batch + (2 * max_k, w), dtype=dtype, device=device)  # cos rows, sin rows
    taken = torch.zeros(batch + (nhalf,), dtype=torch.bool, device=device)
    approx = torch.zeros_like(sdata)
    with full_f32_matmuls():
        for i in range(max_k):
            rc = torch.fft.rfft(sdata - approx, n=M)
            j = torch.where(taken, -math.inf, rc.abs()).argmax(-1, keepdim=True)
            active = i < kc
            taken = taken.scatter(-1, j, taken.gather(-1, j) | active[..., None])
            valid = active.to(dtype)[..., None]
            angles = ((2.0 * math.pi / M) * torch.where(active, j[..., 0], 0).to(dtype))[..., None] * n
            atoms[..., i, :] = torch.cos(angles) * valid
            atoms[..., max_k + i, :] = torch.sin(angles) * valid
            G = atoms @ atoms.mT
            diag = G.diagonal(dim1=-2, dim2=-1)
            load = torch.where(diag < 1e-9, 1.0, 1e-7 * diag.clamp(min=1.0))
            L, _ = cholesky(G + eye2k * load[..., None, :])
            rhs = (atoms @ sdata[..., None])
            z = torch.linalg.solve_triangular(L, rhs, upper=False)
            z = torch.linalg.solve_triangular(L.mT, z, upper=True)
            approx = torch.where(active[..., None], (atoms.mT @ z)[..., 0], approx)
    return approx


def sspain_core(gapped: torch.Tensor, mask: torch.Tensor, maxit: int = 100, s: int = 1,
                r: int = 1, epsilon: float = 1e-3, f_update: str = "h", max_k: int = 32,
                redundancy: int = 2) -> torch.Tensor:
    """S-SPAIN on each row of ``(..., w)`` (``sspain.m:44-100``) with the
    hard-thresholding (``f_update="h"``) or OMP (``"omp"``, up to ``max_k``
    pairs over the ``redundancy``-times oversampled dictionary) f-update."""
    if f_update not in ("h", "omp"):
        raise ValueError(f"f_update must be h|omp, got {f_update!r}")

    def f_update_fn(sig, k):
        if f_update == "omp":
            return omp_approximation(sig, k, max_k=max_k, redundancy=redundancy)
        return _frsyn(hard_threshold_dft(_frana(sig), k))

    with full_f32_matmuls():
        batch = gapped.shape[:-1]
        x0 = torch.where(mask > 0, gapped, 0.0)
        x_hat, u = x0, torch.zeros_like(x0)
        k = torch.full(batch, s, dtype=torch.int64, device=gapped.device)
        best = x0
        best_obj = torch.full(batch, math.inf, dtype=gapped.dtype, device=gapped.device)
        done = torch.zeros(batch, dtype=torch.bool, device=gapped.device)
        for it in range(maxit):
            x_est = f_update_fn(x_hat - u, k)
            obj = torch.linalg.vector_norm(x_est - x_hat, dim=-1)
            best, best_obj, done = _keep_best(obj, x_hat, best, best_obj, done, epsilon)
            x_new = torch.where(mask > 0, x0, x_est + u)
            u_new = u + x_est - x_new
            k_new = k + s if (it + 2) % r == 0 else k
            x_hat = _freeze(done, x_hat, x_new)
            u = _freeze(done, u, u_new)
            k = torch.where(done, k, k_new)
        return best


def spain_inpaint(
    signal: torch.Tensor,
    mask: torch.Tensor,
    gap_start: torch.Tensor,
    gap_len: torch.Tensor,
    algorithm: str = "aspain",
    maxit: int = 100,
    s: int = 1,
    r: int = 1,
    epsilon: float = 1e-3,
    wtype: str = "hann",
    w: int = 4096,
    a: int = 1024,
    max_gap: int = 2048,
) -> torch.Tensor:
    """Segment-wise SPAIN over one contiguous gap a clip
    (``spain_segmentation.m``): ``algorithm`` "aspain", "sspain" (H
    f-update) or "sspain_omp".  ``signal``, ``mask``: ``(B, N)``;
    ``gap_start``, ``gap_len``: ``(B,)``.  The ``K`` windows that can touch
    the gap are solved as one batch; reliable samples are returned verbatim
    (``spain_segmentation.m:98-99``)."""
    if algorithm not in ("aspain", "sspain", "sspain_omp"):
        raise ValueError(f"algorithm must be aspain|sspain|sspain_omp, got {algorithm!r}")
    n = signal.shape[-1]
    gana, gsyn = ola_windows(wtype, w, signal.dtype, signal.device)
    x = torch.where(mask > 0, signal, 0.0)
    xp, mp, starts, pad = gap_windows(x, mask, gap_start, w, a, max_gap)
    data = clamped_window(xp, starts, w) * gana  # (B, K, w)
    seg_mask = clamped_window(mp, starts, w)
    any_miss = (seg_mask <= 0).any(-1)
    if algorithm == "aspain":
        solved = aspain_core(data, seg_mask, maxit=maxit, s=s, r=r, epsilon=epsilon)
    else:
        solved = sspain_core(data, seg_mask, maxit=maxit, s=s, r=r, epsilon=epsilon,
                             f_update="omp" if algorithm == "sspain_omp" else "h")
    solved = torch.where(any_miss[..., None], solved, data)
    out = overlap_add_update(xp, starts, solved, data, gana, gsyn, a)[:, pad : pad + n]
    return torch.where(mask > 0, signal, out)

"""Per-clip windows at data-dependent offsets, as ``lax.dynamic_slice`` and
``lax.dynamic_update_slice`` take them in the JAX solvers: each start is
clamped so that the window lies inside the array.  Every clip has its own
start, so the windows are gathers with index tensors (no host sync)."""

from __future__ import annotations

import torch

__all__ = ["clamped_starts", "clamped_window", "composite_window"]


def clamped_starts(start: torch.Tensor, length: int, size: int) -> torch.Tensor:
    """``start`` clamped to ``[0, length - size]`` (``lax.dynamic_slice``)."""
    return start.clamp(0, length - size)


def clamped_window(v: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """``v[b, s : s + size]`` for each row ``b`` of ``v (B, L)`` and each
    start of ``start (B, ...)``, the starts clamped as ``lax.dynamic_slice``
    clamps them: ``(B, ..., size)``."""
    s = clamped_starts(start, v.shape[-1], size)
    idx = s[..., None] + torch.arange(size, device=v.device)
    return v.gather(-1, idx.flatten(1)).view(idx.shape)


def composite_window(x: torch.Tensor, fill: torch.Tensor, gap_start: torch.Tensor,
                     gap_len: torch.Tensor) -> torch.Tensor:
    """``x (B, N)`` with ``fill (B, M)`` written over its gap, as the JAX
    solvers write it: ``dynamic_update_slice`` of the first ``gap_len``
    values of ``fill`` (the rest keeping ``x``) into ``x`` padded by ``M``
    at ``gap_start`` clamped to ``[0, N]``, cut back to ``N``."""
    n, m = x.shape[-1], fill.shape[-1]
    s = clamped_starts(gap_start, n + m, m)
    rel = torch.arange(n, device=x.device) - s[:, None]
    inside = (rel >= 0) & (rel < m) & (rel < gap_len[:, None])
    return torch.where(inside, fill.gather(-1, rel.clamp(0, m - 1)), x)

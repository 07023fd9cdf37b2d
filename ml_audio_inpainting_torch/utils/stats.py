"""Statistics and interval plots (port of
``ml_audio_inpainting_tpu/utils/stats.py``): bootstrap-t confidence intervals
for means, and the shaded-band and dashed-bound plots of the reference's
result figures.  numpy only, so the intervals are the JAX package's bit for
bit; the plot helpers return None where matplotlib is absent (as
``utils/visualize.py`` does)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["bootstrap_ci", "fill_interval", "plot_interval"]


def bootstrap_ci(
    data: np.ndarray,
    n_boot: int = 1000,
    alpha: float = 0.05,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bootstrap-t confidence interval for the mean along axis 0.

    ``data``: ``(n_samples, ...)``.  Returns ``(mean, lo, hi)``, each of
    shape ``data.shape[1:]``: all ``n_boot`` resamples drawn at once from
    ``default_rng(seed)``, the studentised statistic's ``alpha / 2`` and
    ``1 - alpha / 2`` quantiles mapped back through the sample's standard
    error.  Fewer than two samples give the mean three times.
    """
    data = np.asarray(data, dtype=np.float64)
    n = data.shape[0]
    if n < 2:
        m = data.mean(axis=0)
        return m, m, m
    rng = np.random.default_rng(seed)
    mean = data.mean(axis=0)
    se = data.std(axis=0, ddof=1) / np.sqrt(n)
    se = np.where(se == 0, 1e-12, se)
    idx = rng.integers(0, n, size=(n_boot, n))
    resamples = data[idx]  # (n_boot, n, ...)
    bmean = resamples.mean(axis=1)
    bse = resamples.std(axis=1, ddof=1) / np.sqrt(n)
    bse = np.where(bse == 0, 1e-12, bse)
    t_stats = (bmean - mean) / bse
    t_lo = np.quantile(t_stats, alpha / 2, axis=0)
    t_hi = np.quantile(t_stats, 1 - alpha / 2, axis=0)
    return mean, mean - t_hi * se, mean - t_lo * se


def _have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def fill_interval(ax, x, mean, lo, hi, color=None, alpha: float = 0.25, label=None):
    """A shaded CI band and its centre line on ``ax`` (the line); None where
    matplotlib is absent."""
    if not _have_matplotlib():
        return None
    (line,) = ax.plot(x, mean, color=color, label=label)
    ax.fill_between(x, lo, hi, color=line.get_color(), alpha=alpha, linewidth=0)
    return line


def plot_interval(ax, x, mean, lo, hi, color=None, label=None):
    """A centre line with dashed CI bounds on ``ax`` (the line); None where
    matplotlib is absent."""
    if not _have_matplotlib():
        return None
    (line,) = ax.plot(x, mean, color=color, label=label)
    c = line.get_color()
    ax.plot(x, lo, linestyle="--", color=c, linewidth=0.8)
    ax.plot(x, hi, linestyle="--", color=c, linewidth=0.8)
    return line

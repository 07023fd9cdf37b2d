"""TensorBoard scalar scraping and loss-curve comparison plots (port of
``ml_audio_inpainting_tpu/utils/tb_analysis.py``, after the reference's
``models/GAN/graph.py``): read a scalar tag from event files, merge resumed
runs by global step, EMA-smooth, and plot named runs against each other.

Host only: ``tensorboard`` (its event reader) and ``matplotlib`` are
imported inside the functions that need them; the card's machine has
neither.  numpy otherwise, so the numbers are the JAX package's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["smooth", "load_scalar_runs", "plot_runs"]


def smooth(values: np.ndarray, weight: float = 0.95) -> np.ndarray:
    """EMA smoothing started at the first value (``graph.py:6-14``), in f64."""
    out = np.empty_like(values, dtype=np.float64)
    last = values[0]
    for i, v in enumerate(values):
        last = last * weight + (1 - weight) * v
        out[i] = last
    return out


def load_scalar_runs(run_dirs: Sequence[Union[str, Path]], tag: str
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``(steps, values)`` of scalar ``tag`` over several (possibly resumed)
    run directories, sorted by global step; of a step logged more than once
    the first read is kept (``graph.py:41-54``).  A directory without the
    tag adds nothing."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    steps: List[int] = []
    vals: List[float] = []
    for d in run_dirs:
        acc = EventAccumulator(str(d))
        acc.Reload()
        if tag not in acc.Tags().get("scalars", []):
            continue
        for ev in acc.Scalars(tag):
            steps.append(ev.step)
            vals.append(ev.value)
    order = np.argsort(steps, kind="stable")
    s = np.asarray(steps)[order]
    v = np.asarray(vals)[order]
    _, first = np.unique(s, return_index=True)
    return s[first], v[first]


def plot_runs(
    runs: Dict[str, Sequence[Union[str, Path]]],
    tag: str,
    smooth_weight: float = 0.95,
    title: Optional[str] = None,
    save_path: Optional[Union[str, Path]] = None,
):
    """One scalar tag of each named group of run directories, smoothed, on
    one axis: the figure, or None once saved to ``save_path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for name, dirs in runs.items():
        steps, vals = load_scalar_runs(dirs, tag)
        if len(steps) == 0:
            continue
        ax.plot(steps, smooth(vals, smooth_weight), label=name)
    ax.set_xlabel("step")
    ax.set_ylabel(tag)
    ax.set_title(title or tag)
    ax.legend()
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path)
        plt.close(fig)
        return None
    return fig

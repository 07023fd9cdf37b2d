"""Profiling and step timing (port of
``ml_audio_inpainting_tpu/runtime/profiling.py`` on ``torch.profiler`` and
CUDA events).

:func:`trace` records the host and, on a card, the device activity of a
block with ``torch.profiler`` and writes a Chrome trace (Perfetto and
``chrome://tracing`` read it).  :class:`StepTimer` times steps on the wall
clock; its :meth:`StepTimer.probe` waits for the device work a value
depends on, so a step's time includes it.  JAX's ``start_server`` (a
``jax.profiler`` server for TensorBoard) has no torch counterpart.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional, Union

import numpy as np
import torch

__all__ = ["trace", "StepTimer"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Union[str, Path]) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block into ``log_dir/trace.json`` (Chrome
    trace format, which Perfetto opens), the CUDA activity included when a
    card is present.  Yields the profiler (``key_averages()`` etc.)."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))


class StepTimer:
    """Wall-clock per-step timing with warm-up steps left out and
    percentiles::

        timer = StepTimer(warmup=2)
        for batch in feed:
            with timer:
                state, metrics = step(state, batch)
                timer.probe(metrics["loss"])  # waits for the step's device work
        print(timer.summary())
    """

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def probe(self, value) -> None:
        """Wait for the device work ``value`` (a tensor, or anything numpy
        takes) depends on: a tensor is read to the host."""
        if isinstance(value, torch.Tensor):
            value.detach().cpu()
        else:
            np.asarray(value)

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    def summary(self) -> dict:
        """``steps``, ``mean_ms``, ``p50_ms``, ``p95_ms``, ``steps_per_s`` of
        the steps after the warm-up (empty if none)."""
        ts = np.asarray(self.times[self.warmup:])
        if len(ts) == 0:
            return {}
        return {
            "steps": int(len(ts)),
            "mean_ms": float(ts.mean() * 1e3),
            "p50_ms": float(np.percentile(ts, 50) * 1e3),
            "p95_ms": float(np.percentile(ts, 95) * 1e3),
            "steps_per_s": float(1.0 / ts.mean()),
        }

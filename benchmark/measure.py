"""What a run measures, shared by the loops: the run's outcome, the
process's age, the benchmark's own spans, the reading of a profiler trace,
and the comparisons that decide ``correct``.
"""

from __future__ import annotations

import math
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_T_IMPORT = time.time()


def process_age() -> float:
    """Seconds since this process started (from ``/proc``; since this
    module's import where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - _T_IMPORT


@dataclass
class Check:
    """One number compared, beside its limit: it passes at or below it."""

    name: str
    value: float
    limit: float
    where: str = ""  # the part that reads worst, where the number is a worst case

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a loop hands back: the end-to-end metrics, the checks, the
    counts, the device's peak, and what the per-layer readers read
    (``context``)."""

    end_to_end: Dict[str, float]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    context: Dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(c.ok for c in self.checks)


class Spans:
    """Host seconds spent inside named calls of the benchmark's own loop."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name].append(time.perf_counter() - t0)

    def mean_ms(self, name: str) -> Optional[float]:
        xs = self.seconds.get(name)
        return 1e3 * sum(xs) / len(xs) if xs else None


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def read_trace(prof, units: int) -> Dict:
    """The device's side of a traced stretch of ``units`` requests or steps:
    the stretch from the first kernel's start to the last one's end
    (``window_s``), the union of the kernels' intervals in it (``busy_s``),
    each kernel name's seconds and launches (``kernels``), the ten that took
    longest (``device_ops``), and the ten longest idle gaps labelled by what
    the host was doing then: the innermost host range around the gap's
    start, after the benchmark's own range around it (``idle_gaps``)."""
    from torch.autograd import DeviceType

    kernels, host = [], []
    for evt in prof.events():
        start, end = evt.time_range.start, evt.time_range.end
        if getattr(evt, "is_user_annotation", False) or evt.name.startswith("bench."):
            if evt.device_type != DeviceType.CUDA:  # a range's shadow on the device is no kernel
                host.append((start, end, evt.name))
        elif evt.device_type == DeviceType.CUDA:
            kernels.append((start, end, evt.name))
        elif end > start:
            host.append((start, end, evt.name))
    if not kernels:
        return {}
    t0 = min(k[0] for k in kernels)
    t1 = max(k[1] for k in kernels)
    busy = _union([(s, e) for s, e, _ in kernels])
    by_name = defaultdict(lambda: [0.0, 0])
    for s, e, name in kernels:
        by_name[name][0] += (e - s) * 1e-6
        by_name[name][1] += 1
    longest = sorted(((s1 - e0, e0) for (_, e0), (s1, _) in zip(busy, busy[1:])),
                     reverse=True)[:10]
    gaps = []
    for length, e0 in longest:
        around = [h for h in host if h[0] <= e0 < h[1]]
        inner = min(around, key=lambda h: h[1] - h[0])[2] if around else "none"
        ours = [h[2] for h in sorted(around, key=lambda h: h[1] - h[0]) if h[2].startswith("bench.")]
        label = inner if not ours or ours[0] == inner else f"{ours[0]} > {inner}"
        gaps.append((label, length * 1e-6))
    return {
        "units": units,
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernels": {name: tuple(v) for name, v in by_name.items()},
        "device_ops": sorted(([n[:160], v[0]] for n, v in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": [[label[:160], s] for label, s in gaps],
    }


def profiler():
    """A CPU and CUDA profiler, not yet started."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

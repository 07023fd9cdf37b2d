"""What the per-layer metrics of the program's own spans and counters
share (``ml_audio_inpainting_torch/runtime/profiling.py``).

The program keeps the spans of its latest profiled stretch: with ``--trace
1`` that is the traced stretch after the window, one root span a request
(``serve.request``) or a step (``train.step``), its stages below it.  A
reader returns None unless the run is traced and of its side, and the
stretch holds exactly the trace's ``units`` roots of that side (so a stale
or foreign stretch is never read); a device figure also needs the spans'
CUDA events.  Figures are per unit: summed over the stretch, over its
units.  The benchmark's files may run over an older checkout of the
program, whose ``profiling`` module has no ``stretch``: every reader then
gives None.
"""

from __future__ import annotations

from typing import Iterable, Optional

from benchmark import readers
from ml_audio_inpainting_torch.runtime import profiling

ROOTS = {"serve": "serve.request", "train": "train.step"}


def _stretch(ctx: dict, side: str):
    """``(spans, roots, units)`` of the run's stretch, or None."""
    trace = readers.traced(ctx, side)
    if trace is None or not trace.get("units"):
        return None
    read = getattr(profiling, "stretch", None)
    if read is None:
        return None
    spans = read()
    roots = [s for s in spans if s.parent is None and s.name == ROOTS[side]]
    if len(roots) != trace["units"]:
        return None
    return spans, roots, trace["units"]


def _summed(ctx: dict, side: str, names: Iterable[str], value) -> Optional[float]:
    """``value(span)`` summed over the spans ``names``, a unit."""
    found = _stretch(ctx, side)
    if found is None:
        return None
    spans, _, units = found
    names = set(names)
    values = [value(s) for s in spans if s.name in names]
    if not values or any(v is None for v in values):
        return None
    return sum(values) / units


def device_ms(ctx: dict, side: str, names: Iterable[str]) -> Optional[float]:
    """Device milliseconds a unit in the spans ``names``."""
    return _summed(ctx, side, names, lambda s: s.device_ms)


def host_ms(ctx: dict, side: str, names: Iterable[str]) -> Optional[float]:
    """Host milliseconds a unit in the spans ``names``."""
    return _summed(ctx, side, names, lambda s: s.host_ms)


def counted(ctx: dict, side: str, counter: str) -> Optional[float]:
    """The counter's change a unit, over the root spans."""
    found = _stretch(ctx, side)
    if found is None:
        return None
    _, roots, units = found
    return sum(r.counts.get(counter, 0) for r in roots) / units

"""Profiling: the program's spans and counters, and a trace exporter (port
of ``ml_audio_inpainting_tpu/runtime/profiling.py`` on ``torch.profiler``
and CUDA events).

:func:`span` marks a stage of a request or a step (``serve.request`` and
its ``serve.stft``, ``serve.model``, ...; ``train.step`` and its parts;
``feed.next``).  A span is live only while a torch profiler records; then it

* enters ``record_function(name)``, so the stage lands in the profiler's
  trace, on the device trace's clock, with the kernels it launched under it
  (:func:`trace` exports it);
* records its name, its parent's name and a unit id (the sequence number of
  its root span, the outermost one open, within the stretch) with its host
  start and end (``time.perf_counter_ns``);
* while CUDA is initialised, records a timing CUDA event on the current
  stream where it opens; the next such event after it closes (the next
  span's opening, or its root's end, where the root records one more) is
  its end.  Nothing waits for them; they are resolved when
  :attr:`SpanRecord.device_ms` is read.  Being stream-ordered, they give the
  device time from the end of the work before the span to the end of the
  work before the next boundary: its own kernels, where nothing is launched
  between it and the next span, as at every stage boundary of the program.
  One event a boundary and not a pair a span: recording a timing event
  costs the host 50-100 us on the H100's machine, where the first request
  of a traced stretch is host-bound;
* as a root span, stores the counters' changes over its extent and, on
  CUDA, counts into ``host_syncs`` every synchronising call made inside it
  (``torch.cuda.set_sync_debug_mode("warn")`` for its extent, every
  warning counted; those of the autograd engine's thread reach the caller
  when ``backward`` returns).

A host-only span (``device=False``, the device feed's ``feed.next``, whose
host time alone is read) records no event and watches no syncs.  Not live,
:func:`span` checks one flag and returns a shared no-op context.  A span
whose name is already open is not a new span.  Only the latest profiled
stretch is kept (:func:`stretch`): the first live span after a span call
that was not live starts a new one.

A boundary event is what makes the stages add up to their root: kernels
launched under a root between two of its stages are charged to the stage
before them, so the sum alone cannot show a missing span.
``tests/test_torch_profiling.py`` and ``tests/test_torch_gpu.py`` check from
the profiler's own events that every op under a root that launches work
runs in one of its stages or before the first.

:func:`count` adds to a named counter, always (one dict update): ``stft``
(``ops/stft.py``), the LSTM kernels' launches
(``ops/cuda/lstm_cell.py::kernel_launches``), ``host_syncs``.  JAX's
``start_server`` (a ``jax.profiler`` server for TensorBoard) has no torch
counterpart.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Union

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

__all__ = ["trace", "span", "count", "counters", "reset_counters", "stretch", "SpanRecord"]

TRACE_FILE = "trace.json"
# What ``set_sync_debug_mode("warn")`` says of a synchronising call.
SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def trace(log_dir: Union[str, Path]) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block into ``log_dir/trace.json`` (Chrome
    trace format, which Perfetto opens), the CUDA activity included when a
    card is present; the program's spans are live inside.  Yields the
    profiler (``key_averages()`` etc.)."""
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


_COUNTS: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Every counter's total since its last reset."""
    return dict(_COUNTS)


def reset_counters(names: Iterable[str]) -> None:
    """Set the counters ``names`` back to 0."""
    for name in names:
        _COUNTS.pop(name, None)


@dataclass(eq=False)
class SpanRecord:
    """One live span: ``parent`` is the enclosing span's name (None for a
    root), ``unit`` its root's sequence number in the stretch, ``counts``
    a root's counter changes over its extent (None for the others)."""

    name: str
    parent: Optional[str]
    unit: int
    host_start_ns: int
    host_end_ns: Optional[int] = None
    start_event: Optional[torch.cuda.Event] = None
    end_event: Optional[torch.cuda.Event] = None
    counts: Optional[Dict[str, int]] = None

    @property
    def host_ms(self) -> Optional[float]:
        if self.host_end_ns is None:
            return None
        return 1e-6 * (self.host_end_ns - self.host_start_ns)

    @property
    def device_ms(self) -> Optional[float]:
        """Device milliseconds from the start event to the end event (None
        without them, or before the end is recorded); waits for the end
        event."""
        if self.start_event is None or self.end_event is None:
            return None
        self.end_event.synchronize()
        return self.start_event.elapsed_time(self.end_event)


_stretch: List[SpanRecord] = []
_open: List[SpanRecord] = []  # the live spans open now, outermost first
_ending: List[SpanRecord] = []  # closed spans that end at the next boundary
_fresh = True  # the next live span starts a new stretch
_roots = 0  # root spans in the stretch


def stretch() -> List[SpanRecord]:
    """The spans of the latest profiled stretch, in the order they opened."""
    return list(_stretch)


class _SyncCount:
    """Synchronising calls made while it is open, on CUDA: the sync debug
    mode at ``warn`` and its warnings recorded, the others re-issued."""

    def __enter__(self):
        self.mode = torch.cuda.get_sync_debug_mode()
        self.catcher = warnings.catch_warnings(record=True)
        self.caught = self.catcher.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def close(self) -> int:
        torch.cuda.set_sync_debug_mode(self.mode)
        self.catcher.__exit__(None, None, None)
        syncs = 0
        for w in self.caught:
            if SYNC_WARNING in str(w.message):
                syncs += 1
            else:
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        return syncs


def _boundary() -> torch.cuda.Event:
    """A timing event recorded now on the current stream: the end of every
    span closed since the last one."""
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    for rec in _ending:
        rec.end_event = event
    _ending.clear()
    return event


class _Live:
    __slots__ = ("name", "device", "record", "range", "syncs", "before")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device

    def __enter__(self):
        global _fresh, _stretch, _roots
        if _fresh:
            _stretch, _roots, _fresh = [], 0, False
        self.record = None
        if any(r.name == self.name for r in _open):
            return self
        parent = _open[-1] if _open else None
        if parent is None:
            unit, _roots = _roots, _roots + 1
        else:
            unit = parent.unit
        self.range = record_function(self.name)
        self.range.__enter__()
        cuda = self.device and torch.cuda.is_initialized()
        self.syncs = None
        if parent is None:
            self.before = dict(_COUNTS)
            if cuda:
                self.syncs = _SyncCount().__enter__()
        rec = SpanRecord(self.name, parent.name if parent else None, unit,
                         time.perf_counter_ns(), start_event=_boundary() if cuda else None)
        _open.append(rec)
        _stretch.append(rec)
        self.record = rec
        return self

    def __exit__(self, *exc):
        rec = self.record
        if rec is None:
            return False
        try:
            rec.host_end_ns = time.perf_counter_ns()
            if rec.start_event is not None:
                _ending.append(rec)
                if rec.parent is None:
                    _boundary()
            if rec.parent is None:
                if self.syncs is not None:
                    count("host_syncs", self.syncs.close())
                rec.counts = {k: v - self.before.get(k, 0) for k, v in _COUNTS.items()
                              if v != self.before.get(k, 0)}
        finally:
            _open.remove(rec)
            self.range.__exit__(*exc)
        return False


_IDLE = contextlib.nullcontext()


def span(name: str, device: bool = True):
    """A context for the stage ``name``: live while a torch profiler records
    (the module docstring), else a shared no-op.  ``device=False`` keeps its
    host times only: no CUDA event, no sync watch."""
    global _fresh
    if not _autograd_profiler._is_profiler_enabled:
        _fresh = True
        return _IDLE
    return _Live(name, device)

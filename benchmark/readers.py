"""What the per-layer metrics' readers share.  A reader takes the run's
``context`` (``measure.Outcome.context``) and returns a number, or None
where its run has nothing for it to read: a ``.serve`` metric reads only a
serving run (``unit`` "request"), a ``.train`` one only a training run
(``unit`` "step"), and a device metric only a traced one."""

from __future__ import annotations

from typing import Iterable, Optional

from benchmark import yardstick

UNITS = {"serve": "request", "train": "step"}


def ours(ctx: dict, side: str) -> bool:
    return ctx.get("unit") == UNITS[side]


def traced(ctx: dict, side: str) -> Optional[dict]:
    trace = ctx.get("trace")
    return trace if ours(ctx, side) and trace else None


def kind_ms_per_unit(ctx: dict, side: str, kinds: Iterable[str]) -> Optional[float]:
    """Device milliseconds a request or step of the kernels of ``kinds``
    (:data:`yardstick.KINDS`) in the traced stretch."""
    trace = traced(ctx, side)
    if trace is None:
        return None
    kinds = set(kinds)
    seconds = sum(s for name, (s, _) in trace["kernels"].items()
                  if yardstick.kind_of(name) in kinds)
    return 1e3 * seconds / trace["units"]


def mfu(ctx: dict, side: str) -> Optional[float]:
    """The window's rate of the reference's FLOPs over the peak of the
    cell's element type, in percent."""
    if not ours(ctx, side) or not ctx.get("units"):
        return None
    achieved = ctx["flops_per_unit"] * ctx["units"] / ctx["window_s"]
    return yardstick.share(achieved, yardstick.PEAK_FLOP_PER_S[ctx["dtype"]])


def idle_share(ctx: dict, side: str) -> Optional[float]:
    trace = traced(ctx, side)
    if trace is None:
        return None
    return yardstick.share(trace["window_s"] - trace["busy_s"], trace["window_s"])


def dispatch_ms(ctx: dict, side: str) -> Optional[float]:
    return ctx.get("dispatch_ms") if ours(ctx, side) else None


def peak_mem_gb(ctx: dict, side: str) -> Optional[float]:
    peak = ctx.get("peak_window_bytes")
    return peak / 1e9 if ours(ctx, side) and peak else None


def lstm_roofline(ctx: dict, side: str, fwd_pattern, bwd_pattern, all_pattern) -> Optional[float]:
    """The LSTM calls' least time (``ctx["lstm"]``: seconds a forward call
    and a backward call at the cell's shapes; a call is one launch of the
    forward, or of the backward sweep) over the device time of every kernel
    ``all_pattern`` matches, in percent."""
    trace = traced(ctx, side)
    if trace is None or not ctx.get("lstm"):
        return None
    least = spent = 0.0
    for name, (seconds, launches) in trace["kernels"].items():
        if all_pattern.search(name):
            spent += seconds
        if fwd_pattern.search(name):
            least += launches * ctx["lstm"]["fwd_s"]
        elif bwd_pattern.search(name):
            least += launches * ctx["lstm"]["bwd_s"]
    return yardstick.share(least, spent)

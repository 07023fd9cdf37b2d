"""Minimal-support windowing math for DGT-domain gap processing (a copy of
``ml_audio_inpainting_tpu/classical/support.py``, pure Python).

Reference: ``models/AudioReg/utils/min_sig_supp_2.m`` (smallest signal span
and window series fully covering a gap for window-by-window processing) and
``utils/offset.m`` (grid offset that centers windows on the gap).  The
benchmark script uses these to trim the signal passed to the windowed
Janssen solver (``train.m:144-147``).

Index conventions here are 0-based Python (the MATLAB originals are
1-based); the relationships between outputs are preserved exactly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["gap_offset", "min_sig_supp", "MinSupport"]


def gap_offset(s: int, f: int, a: int, kind: str = "half") -> int:
    """Window-grid offset so processing is symmetric about the gap center.

    ``s``/``f``: first/last missing sample (0-based, inclusive); ``a``:
    window shift.  ``kind``: 'full' (gap center on a window center), 'half'
    (gap center on the symmetry axis of two adjacent windows), 'none'.
    Mirrors ``offset.m`` with the 1-based indices mapped to 0-based.
    """
    if kind == "none":
        return 0
    c = math.ceil((s + f + 2) / 2) - 1  # 0-based gap center (MATLAB ceil((s+f)/2))
    k = c // a
    if kind == "full":
        d = k * a
    elif kind == "half":
        d = k * a + math.ceil(a / 2)
    else:
        raise ValueError(f"kind must be 'full', 'half' or 'none', got {kind!r}")
    return c - d


@dataclass
class MinSupport:
    """Outputs of :func:`min_sig_supp` (0-based, end-exclusive spans)."""

    q: int  # first index of the shortened signal
    Q: int  # last index (inclusive) of the shortened signal
    p: int  # center index of the first useful window
    P: int  # center index of the last useful window
    S: int  # index of the first useful window in the DGT series
    F: int  # index of the last useful window in the DGT series
    u: int  # gap start within the shortened signal
    v: int  # gap end (inclusive) within the shortened signal
    L: int  # length of the shortened signal


def min_sig_supp(
    w: int, a: int, s: int, f: int, n: int, offset: int = 0
) -> MinSupport:
    """Minimal signal range carrying all DGT info about a gap.

    Args (0-based): ``w`` window length, ``a`` shift, ``s``/``f`` first/last
    missing sample (inclusive), ``n`` signal length, ``offset`` from
    :func:`gap_offset`.  Port of ``min_sig_supp_2.m:42-107`` (neig = 1).
    """
    offset = offset % a

    # First useful window (1-based arithmetic from the reference, shifted).
    s1, f1 = s + 1, f + 1  # to MATLAB indices
    S = math.ceil((s1 - math.ceil(w / 2)) / a) + 1
    p = 1 + (S - 1) * a + offset
    if p - a + math.ceil(w / 2) - 1 >= s1:
        S -= 1
        p -= a
    q = p - math.ceil((w // 2) / a) * a
    F = S + (f1 + (w // 2) - p) // a
    P = p + (F - S) * a
    Q = P + math.ceil(math.ceil(w / 2) / a) * a

    u = s1 - q + 1
    v = f1 - q + 1
    L = Q - q + 1
    # Back to 0-based sample indices.
    return MinSupport(
        q=q - 1, Q=Q - 1, p=p - 1, P=P - 1, S=S - 1, F=F - 1, u=u - 1, v=v - 1, L=L
    )

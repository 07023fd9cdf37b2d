"""Long-form inpainting: gaps in a signal of any length through a model of
fixed window (port of ``ml_audio_inpainting_tpu/runtime/longform.py``).

Two ways over one long ``(T,)`` waveform with gaps anywhere:

* :func:`longform_inpaint` cuts the signal into overlapping windows
  (:func:`chunk_signal`), runs the model only on the windows that meet a gap,
  one batched call for up to ``batch_size`` of them, in rounds so that a
  window holding several gaps gets each restoration in turn, and recombines
  the windows by Hann-weighted overlap-add (:func:`overlap_add`);
* :func:`longform_inpaint_centered` serves well-separated gaps with one
  window centred on each gap (``make_centered_gap_fn``), half the model work
  and each gap mid-window as in 5 s serving.

Both composite in time at the end, so the output is the input outside the
gaps bit for bit, and both can hand back one PCM16 patch a gap instead of the
waveform (``runtime/transport.py``'s contract; recombine with
``transport.composite_gap_patches_1d``).  The index arithmetic is done on the
host from the gap list alone; the windows, the model's batches and the
patches stay on the signal's device, with no host read between calls.
Unlike the JAX module, the plain overlap-add path composites too: there its
output is the overlap-add itself, within rounding of the input outside the
gaps.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ml_audio_inpainting_torch.ops.gaps import gap_mask
from ml_audio_inpainting_torch.ops.pcm import to_pcm16

__all__ = [
    "chunk_signal",
    "overlap_add",
    "longform_inpaint",
    "make_centered_gap_fn",
    "longform_inpaint_centered",
]

Gaps = Union[int, np.ndarray, List[int]]


def _n_windows(t: int, window: int, hop: int) -> int:
    return max(1, -(-max(t - window, 0) // hop) + 1)


def chunk_signal(audio: torch.Tensor, window: int, hop: int) -> Tuple[torch.Tensor, int]:
    """``(windows (n, window), padded_len)``: ``(T,)`` cut every ``hop``
    samples into windows of ``window``, the tail zero-padded to
    ``padded_len = (n - 1) * hop + window``; a copy."""
    n = _n_windows(int(audio.shape[-1]), window, hop)
    padded = (n - 1) * hop + window
    x = F.pad(audio, (0, padded - audio.shape[-1]))
    return x.unfold(-1, window, hop).contiguous(), padded


def _device_ints(values, device) -> torch.Tensor:
    """Host integers as an int64 tensor on ``device``; to a card through
    pinned memory without blocking, so the host does not wait for the
    card's queue."""
    t = torch.from_numpy(np.ascontiguousarray(values, dtype=np.int64))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def overlap_add(windows: torch.Tensor, hop: int, length: int) -> torch.Tensor:
    """Hann-weighted overlap-add of ``(n, window)`` back to ``(length,)``:
    each sample is the mean of the windows over it, weighted by
    ``np.hanning(window) + 1e-3`` (strictly positive; computed in f64 on the
    windows' device).  ``F.fold`` sums the windows in order, the same on
    every call."""
    n, w = windows.shape
    win = (torch.hann_window(w, periodic=False, dtype=torch.float64, device=windows.device)
           + 1e-3).to(windows.dtype)
    total = (n - 1) * hop + w

    def fold(x):
        return F.fold(x.T[None], output_size=(1, total), kernel_size=(1, w),
                      stride=(1, hop)).reshape(total)

    return (fold(windows * win) / fold(win.expand(n, w)))[:length]


def _union_valid(length: int, starts: torch.Tensor, lengths: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """``(length,)``: 0 inside any gap, 1 elsewhere."""
    if starts.numel() == 0:
        return torch.ones(length, dtype=dtype, device=starts.device)
    return gap_mask(length, starts, lengths, dtype=dtype).amin(dim=0)


def _patches(out: torch.Tensor, starts: torch.Tensor, patch_window: int,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PCM16 patches ``(k, patch_window)`` of ``out`` ``(..., L)`` at
    ``starts`` clamped into the signal, and the starts as int32."""
    start = torch.clamp(starts, 0, out.shape[-1] - patch_window)
    idx = start[:, None] + torch.arange(patch_window, device=out.device)
    rows = out.expand(len(start), -1) if out.ndim == 1 else out
    return to_pcm16(torch.gather(rows, 1, idx)), start.to(torch.int32)


@torch.inference_mode()
def longform_inpaint(
    inpaint_fn: Callable,
    audio: torch.Tensor,
    gap_start: Gaps,
    gap_len: Gaps,
    window: int = 80000,
    hop: int = 40000,
    batch_size: int = 16,
    pad_batches: bool = False,
    gap_fetch: Optional[int] = None,
):
    """Inpaint gaps anywhere in ``audio`` ``(T,)`` with a fixed-window model.

    ``inpaint_fn(audio (B, window), gap_start (B,), gap_len (B,)) ->
    (restored, aux)`` is any batched inpaint function of
    ``runtime/inference.py``.  ``gap_start``/``gap_len`` are a scalar or
    equal-length sequences of sample counts (host values).  Only windows that
    meet a gap run the model, at most ``batch_size`` a call; a window meeting
    several gaps is restored in successive rounds, each reading the earlier
    rounds' result.  ``pad_batches`` pads every call to ``batch_size`` rows
    (zero-length gaps) so that every call has one shape.

    Returns the ``(T,)`` restored waveform, equal to ``audio`` outside the
    gaps bit for bit; or, with ``gap_fetch`` set (a patch window >= the
    longest gap), ``(patches (n_gaps, gap_fetch) int16, starts (n_gaps,)
    int32)`` on ``audio``'s device, one PCM16 patch a gap.
    """
    gap_starts = np.atleast_1d(np.asarray(gap_start, dtype=np.int64))
    gap_lens = np.atleast_1d(np.asarray(gap_len, dtype=np.int64))
    t = int(audio.shape[-1])
    device = audio.device
    windows, _ = chunk_signal(audio, window, hop)
    starts = np.arange(windows.shape[0]) * hop

    # One (window, local gap start, local gap end) item a window-gap meeting.
    items = []
    for g0, gl in zip(gap_starts.tolist(), gap_lens.tolist()):
        if gl <= 0:
            continue
        g1 = g0 + gl
        for w in np.nonzero((starts < g1) & (starts + window > g0))[0]:
            items.append((int(w), int(max(g0 - starts[w], 0)), int(min(g1 - starts[w], window))))

    # Rounds: each window at most once a round.
    rounds: List[list] = []
    for it in items:
        for r in rounds:
            if all(o[0] != it[0] for o in r):
                r.append(it)
                break
        else:
            rounds.append([it])

    # Every call's (window, local start, local length) rows, and the gaps,
    # go to the device in one copy.
    calls = [r[i : i + batch_size] for r in rounds for i in range(0, len(r), batch_size)]
    rows = [(c[0], c[1], c[2] - c[1]) for chunk in calls for c in chunk]
    host = np.concatenate([np.asarray(rows, np.int64).reshape(-1, 3).T.reshape(-1),
                           gap_starts, gap_lens])
    packed = _device_ints(host, device)
    sel_all, ls_all, gl_all, gs, gl = packed.split([len(rows)] * 3 + [len(gap_starts)] * 2)
    at = 0
    for chunk in calls:
        k = len(chunk)
        npad = batch_size - k if pad_batches else 0
        sel = sel_all[at : at + k]
        batch, ls, lens = windows.index_select(0, sel), ls_all[at : at + k], gl_all[at : at + k]
        if npad:  # zero-length gaps at 0 on zero rows
            batch = torch.cat([batch, batch.new_zeros(npad, window)])
            ls, lens = F.pad(ls, (0, npad)), F.pad(lens, (0, npad))
        restored, _ = inpaint_fn(batch, ls, lens)
        windows.index_copy_(0, sel, restored[:k])
        at += k

    valid = _union_valid(t, gs, gl, audio.dtype)
    out = audio * valid + overlap_add(windows, hop, t) * (1.0 - valid)
    if gap_fetch is None:
        return out
    return _patches(out, gs, gap_fetch)


def make_centered_gap_fn(inpaint_fn: Callable, window: int,
                         patch_window: int = 2048) -> Callable:
    """``fn(audio (T,), gap_start (B,), gap_len (B,)) -> (patches (B,
    patch_window) int16, starts (B,) int32)``, tensors on ``audio``'s
    device: a ``window`` centred on each gap (clamped into the signal) cut
    from ``audio``, the batch inpainted in one call, composited in time, and
    one PCM16 patch a gap at its start (clamped into its window), with the
    starts in the long signal's coordinates.  Pad unused rows with
    zero-length gaps.  Each gap's window must hold no other gap
    (:func:`longform_inpaint_centered` checks it)."""

    @torch.inference_mode()
    def fn(audio: torch.Tensor, gap_start: torch.Tensor,
           gap_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        t = audio.shape[-1]
        if window > t:
            raise ValueError(f"window {window} exceeds signal length {t}")
        wstart = torch.clamp(gap_start + gap_len // 2 - window // 2, 0, t - window)
        idx = wstart[:, None] + torch.arange(window, device=audio.device)
        wins = audio[idx]
        local = gap_start - wstart
        restored, _ = inpaint_fn(wins, local, gap_len)
        masks = gap_mask(window, local, gap_len, dtype=audio.dtype)
        composited = wins * masks + restored * (1.0 - masks)
        patches, pstart = _patches(composited, local, patch_window)
        return patches, (wstart + pstart).to(torch.int32)

    return fn


def longform_inpaint_centered(
    inpaint_fn: Callable,
    audio: torch.Tensor,
    gap_start: Gaps,
    gap_len: Gaps,
    window: int = 80000,
    batch_size: int = 8,
    patch_window: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`make_centered_gap_fn` over any number of gaps (host values):
    raises ``ValueError`` unless every two gaps lie at least ``window``
    apart (use :func:`longform_inpaint` for clusters), pads each group of
    ``batch_size`` gaps with zero-length ones so that every call has one
    shape, and returns ``(patches (n_gaps, patch_window) int16, starts
    (n_gaps,) int32)`` on ``audio``'s device, in the order given."""
    gs = np.atleast_1d(np.asarray(gap_start, np.int64))
    gl = np.atleast_1d(np.asarray(gap_len, np.int64))
    order = np.argsort(gs)
    s_sorted, l_sorted = gs[order], gl[order]
    for i in range(len(s_sorted) - 1):
        if s_sorted[i + 1] - (s_sorted[i] + l_sorted[i]) < window:
            raise ValueError(
                "centered long-form path requires gap spacing >= window "
                f"({window} samples); gaps at {int(s_sorted[i])} and "
                f"{int(s_sorted[i + 1])} are closer -- use longform_inpaint"
            )
    fn = make_centered_gap_fn(inpaint_fn, window, patch_window=patch_window)
    patches, starts = [], []
    for i in range(0, len(gs), batch_size):
        n = len(gs[i : i + batch_size])
        bs, bl = np.zeros(batch_size, np.int64), np.zeros(batch_size, np.int64)
        bs[:n], bl[:n] = gs[i : i + n], gl[i : i + n]
        gaps = _device_ints(np.concatenate([bs, bl]), audio.device)
        p, s = fn(audio, gaps[:batch_size], gaps[batch_size:])
        patches.append(p[:n])
        starts.append(s[:n])
    return torch.cat(patches), torch.cat(starts)

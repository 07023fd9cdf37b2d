"""Batched STFT / iSTFT (port of ``ml_audio_inpainting_tpu/ops/stft.py``).

Explicit framing, ``torch.fft.rfft``/``irfft`` and an overlap-add by
``F.fold`` (deterministic on the card), with the JAX package's numerics:

* the periodic Hann window, of ``win_length`` samples zero-padded centrally to
  ``n_fft``;
* ``center=True`` pads the signal with **zeros** by ``n_fft // 2`` on both
  sides (``torch.stft`` would pad with reflection);
* the iSTFT divides by the window sum-square only where it exceeds
  ``finfo.tiny`` (``torch.istft`` raises where the NOLA check fails).

Waveforms ``(..., T)`` go in, complex spectrograms ``(..., F, N)`` come out.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ml_audio_inpainting_torch.runtime.profiling import count

__all__ = ["get_window", "pad_center", "num_frames", "frame_signal", "stft", "istft", "magnitude"]


def get_window(
    window: str, win_length: int, dtype: torch.dtype = torch.float32, device=None
) -> torch.Tensor:
    """The periodic (DFT-even) Hann window, as scipy/librosa give it.  The
    serving path's STFT uses no other window, as in the JAX package.  It is
    computed in f64 where it is used: a copy from host memory would make the
    host wait for the card's queue on every call."""
    if window != "hann":
        raise ValueError(f"Unsupported window type: {window!r} (the port has only 'hann')")
    n = torch.arange(win_length, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)).to(dtype)


def pad_center(window: torch.Tensor, size: int) -> torch.Tensor:
    """Centre-pad a window to ``size`` samples (librosa ``util.pad_center``)."""
    n = window.shape[-1]
    if n > size:
        raise ValueError(f"window length {n} > target size {size}")
    lpad = (size - n) // 2
    return F.pad(window, (lpad, size - n - lpad))


def num_frames(n_samples: int, hop_length: int, n_fft: int, center: bool = True) -> int:
    """The number of STFT frames of a signal of ``n_samples``."""
    if center:
        return 1 + n_samples // hop_length
    return 1 + (n_samples - n_fft) // hop_length


def frame_signal(y: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """Overlapping frames ``(..., N, frame_length)`` of ``(..., T)`` (a view)."""
    return y.unfold(-1, frame_length, hop_length)


def stft(
    y: torch.Tensor,
    n_fft: int = 512,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    window: str = "hann",
    center: bool = True,
) -> torch.Tensor:
    """Short-time Fourier transform of ``(..., T)`` -> complex ``(..., F, N)``
    (each call counted as ``stft``, ``runtime/profiling.py``)."""
    count("stft")
    if hop_length is None:
        hop_length = n_fft // 4
    if win_length is None:
        win_length = n_fft
    win = pad_center(get_window(window, win_length, y.dtype, y.device), n_fft)
    if center:
        pad = n_fft // 2
        y = F.pad(y, (pad, pad), mode="constant")
    frames = frame_signal(y, n_fft, hop_length)  # (..., N, n_fft)
    spec = torch.fft.rfft(frames * win, n=n_fft, dim=-1)  # (..., N, F)
    return spec.transpose(-1, -2)


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Sum of ``(B, N, L)`` frames placed ``hop_length`` apart: ``(B, 1, 1,
    L + hop_length * (N - 1))``.  ``F.fold`` gathers each output sample's
    terms in frame order, so the sum is the same on every call (a scatter
    with ``index_add_`` adds them with atomics on the card, in any order)."""
    n, length = frames.shape[-2:]
    total = length + hop_length * (n - 1)
    return F.fold(frames.transpose(1, 2), output_size=(1, total), kernel_size=(1, length),
                  stride=(1, hop_length))


def istft(
    spec: torch.Tensor,
    n_fft: Optional[int] = None,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    window: str = "hann",
    center: bool = True,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Inverse STFT of complex ``(..., F, N)`` -> ``(..., T)``: windowed
    overlap-add normalised by the window sum-square."""
    if n_fft is None:
        n_fft = 2 * (spec.shape[-2] - 1)
    if hop_length is None:
        hop_length = n_fft // 4
    if win_length is None:
        win_length = n_fft

    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)  # (..., N, n_fft)
    real_dtype = frames.dtype
    win = pad_center(get_window(window, win_length, real_dtype, frames.device), n_fft)
    frames = frames * win

    n = frames.shape[-2]
    total = n_fft + hop_length * (n - 1)
    batch = frames.shape[:-2]
    out = _overlap_add(frames.reshape(-1, n, n_fft), hop_length).reshape(batch + (total,))
    wss = _overlap_add((win * win).expand(1, n, n_fft), hop_length).reshape(total)
    tiny = torch.finfo(real_dtype).tiny
    nonzero = wss > tiny
    out = torch.where(nonzero, out / torch.where(nonzero, wss, torch.ones_like(wss)), out)

    start = n_fft // 2 if center else 0
    end = start + length if length is not None else total - start
    out = out[..., start : min(end, total)]
    if length is not None and out.shape[-1] < length:
        out = F.pad(out, (0, length - out.shape[-1]))
    return out


def magnitude(spec: torch.Tensor, power: float = 1.0) -> torch.Tensor:
    """``|S| ** power``."""
    mag = spec.abs()
    if power != 1.0:
        mag = mag**power
    return mag

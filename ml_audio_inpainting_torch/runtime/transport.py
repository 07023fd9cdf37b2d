"""Gap-only PCM16 serving transport (port of
``ml_audio_inpainting_tpu/runtime/transport.py``): fetch the reconstructed
gap, not the clip.

Outside the gap every sample of the restored clip is the input's, which the
client already holds, so the card returns one fixed window around each gap:

* device -> host: ``patch``, ``(B, window)`` int16, the PCM16 quantisation
  of the restored waveform over ``[start, start + window)``, and ``start``,
  ``(B,)`` int32, with ``start = clamp(gap_start, 0, n - window)`` so the
  window covers a gap of up to ``window`` samples;
* host side: :func:`composite_gap_patch` writes each patch into the client's
  own PCM16 copy of its input.  The wrapper recomposites in time on the card
  before slicing (``audio * mask + restored * (1 - mask)``, which changes
  nothing for a regime that composited already), so the result equals a
  full-clip ``to_pcm16(restored)`` fetch of that composite exactly, int16
  for int16.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ml_audio_inpainting_torch.ops.gaps import gap_mask
from ml_audio_inpainting_torch.ops.pcm import to_pcm16
from ml_audio_inpainting_torch.runtime.profiling import span

__all__ = [
    "DEFAULT_PATCH_WINDOW",
    "make_gap_transport_fn",
    "composite_gap_patch",
    "composite_gap_patches_1d",
]

# 2048 samples = 128 ms at 16 kHz: covers the reference's evaluated short
# gaps (40-120 ms) with margin.
DEFAULT_PATCH_WINDOW = 2048


def make_gap_transport_fn(inpaint_fn: Callable, window: int = DEFAULT_PATCH_WINDOW) -> Callable:
    """Wrap ``inpaint_fn(audio, gap_start, gap_len) -> (restored, aux)`` into
    ``fn(audio, gap_start, gap_len) -> (patch, start)``, both on the card:
    ``patch`` ``(B, window)`` int16, ``start`` ``(B,)`` int32.  A gap longer
    than ``window`` is not wholly in its patch (the caller's contract, as in
    the JAX package); a window longer than the clip raises.  A call is one
    ``serve.request`` span (``runtime/profiling.py``), its own work after the
    inpaint call ``serve.transport``."""

    @torch.inference_mode()
    def fn(audio: torch.Tensor, gap_start: torch.Tensor,
           gap_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with span("serve.request"):
            n = audio.shape[-1]
            if window > n:
                raise ValueError(f"patch window {window} exceeds clip length {n}")
            restored, _ = inpaint_fn(audio, gap_start, gap_len)
            with span("serve.transport"):
                tmask = gap_mask(n, gap_start, gap_len, dtype=audio.dtype)
                composited = audio * tmask + restored * (1.0 - tmask)
                start = torch.clamp(gap_start, 0, n - window)
                idx = start[:, None] + torch.arange(window, device=audio.device)
                patch = torch.gather(composited, 1, idx)
                return to_pcm16(patch), start.to(torch.int32)

    return fn


def composite_gap_patch(audio_pcm16: np.ndarray, patch: np.ndarray,
                        start: np.ndarray) -> np.ndarray:
    """Client side: write each row's patch into a copy of the client's
    ``(B, S)`` int16 input at its ``start``; the ``(B, S)`` int16
    deliverable."""
    out = np.array(audio_pcm16, copy=True)
    patch = np.asarray(patch)
    start = np.asarray(start)
    w = patch.shape[-1]
    for b in range(out.shape[0]):
        s = int(start[b])
        out[b, s : s + w] = patch[b]
    return out


def composite_gap_patches_1d(audio_pcm16: np.ndarray, patches: np.ndarray,
                             starts: np.ndarray) -> np.ndarray:
    """Client side for one long signal with several gaps: write each patch
    into a copy of the 1-D int16 input at its start.  Overlapping patches
    agree where they overlap, being slices of one composited signal."""
    out = np.array(audio_pcm16, copy=True)
    for patch, s in zip(np.asarray(patches), np.asarray(starts)):
        s = int(s)
        out[s : s + patch.shape[-1]] = patch
    return out

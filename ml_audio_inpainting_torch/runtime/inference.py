"""Batched CNN+BiLSTM inpainting: gapped waveform -> restored waveform
(port of ``ml_audio_inpainting_tpu/runtime/inference.py::make_cnn_inpaint_fn``
and the ``oracle``/``impaired`` branches of ``_reconstruct``).

Per batch: STFT, the frame gap mask (floor rule at both ends, 1 = gap), the
log10 magnitude with the gap frames zeroed, the model, the composite of its
prediction into the gap frames, ``10 ** x``, and the iSTFT under the phase
regime:

* ``oracle``   -- the clean signal's STFT feeds the model and its phase
  rebuilds the waveform (the reference protocol and the CLI default);
* ``impaired`` -- everything from the gapped waveform; the output is
  composited in time, so samples outside the gap are the input's.

``extrapolate`` and ``griffinlim`` wait for the port's phase-regime slice.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ml_audio_inpainting_torch.ops import masking
from ml_audio_inpainting_torch.ops.gaps import gap_mask
from ml_audio_inpainting_torch.ops.stft import istft, stft
from ml_audio_inpainting_torch.utils.config import Config

__all__ = ["PHASE_MODES", "make_cnn_inpaint_fn"]

PHASE_MODES = ("oracle", "impaired", "extrapolate", "griffinlim")
PORTED_PHASE_MODES = ("oracle", "impaired")


def _check_phase(phase: str) -> None:
    if phase not in PHASE_MODES:
        raise ValueError(f"phase must be one of {PHASE_MODES}, got {phase!r}")
    if phase not in PORTED_PHASE_MODES:
        raise NotImplementedError(
            f"phase={phase!r} waits for the phase-regime slice of the port "
            f"(ops/phase.py, ops/griffinlim.py); ported: {PORTED_PHASE_MODES}"
        )


def make_cnn_inpaint_fn(cfg: Config, model: torch.nn.Module, phase: str = "oracle") -> Callable:
    """``fn(audio, gap_start, gap_len) -> (restored, composited)``.

    ``audio`` is ``(B, S)`` clean waveforms; ``gap_start``/``gap_len`` are
    ``(B,)`` integer sample counts on the same device.  ``restored`` is
    ``(B, S)``; ``composited`` is the ``(B, F, N)`` log10 magnitude with the
    prediction inside the gap frames.  The model's weights stay in ``model``.
    The model is applied in eval mode (BatchNorm's running statistics, left
    as they are), as the JAX function applies it with ``train=False``,
    whatever mode the caller left it in; that mode is restored after.
    """
    spec_cfg = cfg.data.spectrogram
    _check_phase(phase)
    kw = dict(
        n_fft=spec_cfg.n_fft,
        hop_length=spec_cfg.hop_length,
        win_length=spec_cfg.win_length,
    )
    hop = spec_cfg.hop_length

    @torch.inference_mode()
    def fn(
        audio: torch.Tensor, gap_start: torch.Tensor, gap_len: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        n_samples = audio.shape[-1]
        tmask = gap_mask(n_samples, gap_start, gap_len, dtype=audio.dtype)  # 1 = valid
        if phase == "oracle":
            base = stft(audio, **kw)
        else:
            base = stft(audio * tmask, **kw)
        F, N = base.shape[-2:]

        # Frame rule: floor at both ends, 1 = gap.
        t = torch.arange(N, device=audio.device)
        hole = (t >= (gap_start // hop)[:, None]) & (t < ((gap_start + gap_len) // hop)[:, None])
        gmask = hole.to(audio.dtype)[:, None, :].expand(-1, F, -1)

        log_impaired = torch.log10(base.abs() * (1.0 - gmask) + masking.LOG10_EPS)
        was_training = model.training
        model.eval()
        try:
            pred = model(log_impaired)
        finally:
            model.train(was_training)
        composited = pred * gmask + log_impaired * (1.0 - gmask)
        out_mag = masking.log10_denorm(composited)
        # Bins of frames that lie wholly in the gap are exactly zero, and an
        # rFFT returns some of them with a real part of -0.0, whose angle is
        # pi.  Which ones is up to the FFT library (the JAX path inherits its
        # FFT's choice), so fix phase 0 wherever |S| = 0.
        phase_of = torch.where(base == 0, 0.0, base.angle())
        rec = istft(torch.polar(out_mag, phase_of), length=n_samples, **kw)
        if phase == "oracle":
            return rec, composited
        return audio * tmask + rec * (1.0 - tmask), composited

    return fn

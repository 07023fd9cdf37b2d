"""Batched inpainting: gapped waveform -> restored waveform (port of
``ml_audio_inpainting_tpu/runtime/inference.py::make_gan_inpaint_fn`` and
``make_cnn_inpaint_fn``, with the ``oracle``/``impaired`` branches of
``_reconstruct``).

GAN, per batch: the gap zeroed in time, the STFTs of the clean and the gapped
clip, ``log1p`` of the gapped magnitude, the frame mask (floor/ceil rule,
1 = valid), the PConv U-Net, then by ``mode``: ``parity`` feeds its
log1p-domain output straight to the iSTFT as a magnitude (the reference's
quirk); ``enhanced`` composites it into the gap frames of the reference
magnitude (clean under ``oracle``, gapped under ``impaired``) and applies
``expm1``.

CNN+BiLSTM, per batch: STFT, the frame gap mask (floor rule at both ends,
1 = gap), the log10 magnitude with the gap frames zeroed, the model, the
composite of its prediction into the gap frames, ``10 ** x``.

Both rebuild the waveform by the iSTFT under the phase regime:

* ``oracle``   -- the clean signal's phase rebuilds the waveform (the
  reference protocol and the CLI default; the CNN+BiLSTM also takes the
  clean STFT as its input);
* ``impaired`` -- everything from the gapped waveform; the output is
  composited in time, so samples outside the gap are the input's.

Where a bin is exactly zero its phase is taken as 0 (:func:`_phase_of`).

``extrapolate`` and ``griffinlim`` wait for the port's phase-regime slice.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Tuple

import torch

from ml_audio_inpainting_torch.ops import masking
from ml_audio_inpainting_torch.ops.gaps import frame_mask_from_interval, gap_mask
from ml_audio_inpainting_torch.ops.stft import istft, stft
from ml_audio_inpainting_torch.utils.config import Config

__all__ = ["PHASE_MODES", "make_gan_inpaint_fn", "make_cnn_inpaint_fn"]

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


def _phase_of(spec: torch.Tensor) -> torch.Tensor:
    """``angle(spec)``, but 0 wherever ``spec`` is exactly zero.  Bins of
    frames that lie wholly in the gap are exactly zero, and an rFFT returns
    some of them with a real part of -0.0, whose angle is pi.  Which ones is
    up to the FFT library (the JAX path inherits its FFT's choice)."""
    return torch.where(spec == 0, 0.0, spec.angle())


def make_gan_inpaint_fn(
    cfg: Config,
    generator: torch.nn.Module,
    mode: str = "parity",
    compute_dtype: Optional[torch.dtype] = None,
    phase: str = "oracle",
) -> Callable:
    """``fn(audio, gap_start, gap_len) -> (restored, generated)``.

    ``audio`` is ``(B, S)`` clean f32 waveforms; ``gap_start``/``gap_len``
    are ``(B,)`` integer sample counts on the same device; the gap is zeroed
    inside.  ``restored`` is ``(B, S)``; ``generated`` is the generator's
    ``(B, F, N)`` output (log1p domain, in [-1, 1]) in f32.

    ``compute_dtype=torch.bfloat16`` runs the generator in bf16 as the JAX
    function does: a bf16 copy of ``generator`` (parameters, BatchNorm
    statistics and buffers), made once here, takes bf16 inputs, and every
    op of the generator runs in bf16, the mask's ones-conv and the ratio
    included; its output is cast back to f32 and the DSP stays f32.  The
    copy does not follow later changes to ``generator``'s weights.

    The generator is applied in eval mode (BatchNorm's running statistics),
    as the JAX function applies it with ``train=False``; the caller's mode
    is restored after.
    """
    spec_cfg = cfg.data.spectrogram
    if mode not in ("parity", "enhanced"):
        raise ValueError(f"mode must be 'parity' or 'enhanced', got {mode!r}")
    _check_phase(phase)
    if mode == "parity" and phase != "oracle":
        # parity feeds the log1p-domain output straight to the iSTFT; any
        # other phase over a log-domain "magnitude" is meaningless.
        raise ValueError("non-oracle phase regimes require mode='enhanced'")
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {compute_dtype}")
    net = generator if compute_dtype is None else copy.deepcopy(generator).to(compute_dtype).eval()
    kw = dict(
        n_fft=spec_cfg.n_fft,
        hop_length=spec_cfg.hop_length,
        win_length=spec_cfg.win_length,
    )

    @torch.inference_mode()
    def fn(
        audio: torch.Tensor, gap_start: torch.Tensor, gap_len: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        n_samples = audio.shape[-1]
        tmask = gap_mask(n_samples, gap_start, gap_len, dtype=audio.dtype)  # 1 = valid
        spec_clean = stft(audio, **kw)
        spec_gap = stft(audio * tmask, **kw)
        log_impaired = masking.log1p_norm(spec_gap.abs())
        F, N = spec_clean.shape[-2:]
        fmask = frame_mask_from_interval(gap_start, gap_start + gap_len, F, N,
                                         spec_cfg.hop_length, dtype=audio.dtype)

        in_dtype = compute_dtype or audio.dtype
        was_training = generator.training
        generator.eval()
        try:
            generated = net(log_impaired.to(in_dtype), fmask.to(in_dtype)).to(audio.dtype)
        finally:
            generator.train(was_training)

        # The reference spectrum gives the magnitude outside the gap frames
        # (enhanced) and the phase: the clean one under oracle, else the gapped.
        ref_spec = spec_clean if phase == "oracle" else spec_gap
        if mode == "parity":
            out_mag = generated  # the reference feeds the log1p-domain output directly
        else:
            composited = masking.composite(generated, masking.log1p_norm(ref_spec.abs()), fmask)
            out_mag = masking.log1p_denorm(composited)
        rec = istft(torch.polar(out_mag, _phase_of(ref_spec)), length=n_samples, **kw)
        if phase == "oracle":
            return rec, generated
        return audio * tmask + rec * (1.0 - tmask), generated

    return fn


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
        rec = istft(torch.polar(out_mag, _phase_of(base)), length=n_samples, **kw)
        if phase == "oracle":
            return rec, composited
        return audio * tmask + rec * (1.0 - tmask), composited

    return fn

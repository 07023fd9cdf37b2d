"""Batched inpainting: gapped waveform -> restored waveform (port of
``ml_audio_inpainting_tpu/runtime/inference.py``: ``make_gan_inpaint_fn``,
``make_cnn_inpaint_fn``, the phase-mode ``make_cnn_phase_inpaint_fn``, the
mask-driven ``make_gan_inpaint_mask_fn`` and ``make_cnn_inpaint_mask_fn``, the
shift ensemble ``make_tta_shift_fn``, and the checkpoint router
``route_checkpoint``).

GAN, per batch: the gap zeroed in time, the STFTs of the clean and the gapped
clip, ``log1p`` of the gapped magnitude, the frame mask (1 = valid), the PConv
U-Net, then by ``mode``: ``parity`` feeds its log1p-domain output straight to
the iSTFT as a magnitude (the reference's quirk); ``enhanced`` composites it
into the gap frames of the reference magnitude (clean under ``oracle``,
gapped otherwise) and applies ``expm1``.

CNN+BiLSTM, per batch: STFT, the frame gap mask (1 = gap), the log10
magnitude with the gap frames zeroed, the model, the composite of its
prediction into the gap frames, ``10 ** x``.

Both rebuild the waveform under the phase regime (:func:`_reconstruct`):

* ``oracle``      -- the clean signal's phase everywhere, the gap included
  (the reference protocol and the CLI default; it uses samples a real user
  has lost; the CNN+BiLSTM also takes the clean STFT as its input);
* ``impaired``    -- the gapped signal's phase;
* ``extrapolate`` -- the gapped signal's phase with every frame whose window
  touches a missing sample replaced by the phase-vocoder extrapolation from
  the trustworthy frames around it (``ops/phase.py``);
* ``griffinlim``  -- momentum Griffin-Lim (``ops/griffinlim.py``), started
  from the extrapolated phase.

The last three are deployable: everything comes from the gapped waveform,
and the output is composited in time, so every sample outside the gap is the
input's, bit for bit.  Where a bin is exactly zero its phase is taken as 0
(:func:`_phase_of`).
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Optional, Tuple

import torch

from ml_audio_inpainting_torch.ops import masking
from ml_audio_inpainting_torch.ops.gaps import (
    frame_mask_from_interval,
    frame_mask_from_sample_mask,
    gap_mask,
)
from ml_audio_inpainting_torch.ops.griffinlim import griffinlim
from ml_audio_inpainting_torch.ops.phase import extrapolate_phase, window_clear_frame_mask
from ml_audio_inpainting_torch.ops.stft import istft, stft
from ml_audio_inpainting_torch.utils.config import Config

__all__ = [
    "PHASE_MODES",
    "make_gan_inpaint_fn",
    "make_cnn_inpaint_fn",
    "make_cnn_phase_inpaint_fn",
    "make_gan_inpaint_mask_fn",
    "make_cnn_inpaint_mask_fn",
    "make_tta_shift_fn",
    "LONGGAP_THRESHOLD_S",
    "route_checkpoint",
]

PHASE_MODES = ("oracle", "impaired", "extrapolate", "griffinlim")

# Gap length (s) past which the standard GAN checkpoint (trained on gaps of
# up to 200 ms) yields to the long-gap variant: the JAX package's measured
# crossover between its 0.16 s and 0.32 s sweep points
# (results/gap_length_sweep.json).
LONGGAP_THRESHOLD_S = 0.25


def route_checkpoint(
    gap_len_s: float,
    checkpoint: Optional[str],
    longgap_checkpoint: Optional[str],
    threshold_s: float = LONGGAP_THRESHOLD_S,
) -> Optional[str]:
    """The weights to serve a gap of ``gap_len_s`` seconds with:
    ``longgap_checkpoint`` when it is given and the gap is longer than
    ``threshold_s``, else ``checkpoint``."""
    if longgap_checkpoint and gap_len_s > threshold_s:
        return longgap_checkpoint
    return checkpoint


def _check_phase(phase: str) -> None:
    if phase not in PHASE_MODES:
        raise ValueError(f"phase must be one of {PHASE_MODES}, got {phase!r}")


def _check_gan(mode: str, phase: str, compute_dtype) -> None:
    if mode not in ("parity", "enhanced"):
        raise ValueError(f"mode must be 'parity' or 'enhanced', got {mode!r}")
    _check_phase(phase)
    if mode == "parity" and phase != "oracle":
        # parity feeds the log1p-domain output straight to the iSTFT; any
        # other phase over a log-domain "magnitude" is meaningless.
        raise ValueError("non-oracle phase regimes require mode='enhanced'")
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {compute_dtype}")


def _phase_of(spec: torch.Tensor) -> torch.Tensor:
    """``angle(spec)``, but 0 wherever ``spec`` is exactly zero.  Bins of
    frames that lie wholly in the gap are exactly zero, and an rFFT returns
    some of them with a real part of -0.0, whose angle is pi.  Which ones is
    up to the FFT library (the JAX path inherits its FFT's choice)."""
    return torch.where(spec == 0, 0.0, spec.angle())


def _spec_kw(cfg: Config) -> dict:
    s = cfg.data.spectrogram
    return dict(n_fft=s.n_fft, hop_length=s.hop_length, win_length=s.win_length)


def _reconstruct(out_mag: torch.Tensor, spec_clean: Optional[torch.Tensor],
                 spec_gap: Optional[torch.Tensor], audio: torch.Tensor,
                 sample_valid: torch.Tensor, phase: str, gl_iters: int, kw: dict) -> torch.Tensor:
    """The waveform of ``out_mag`` under the phase regime: the clean phase
    under ``oracle``, else the gapped one, extrapolated over the frames
    whose window touches a sample where ``sample_valid`` (``(B, S)``, 1 =
    valid) is 0, refined by Griffin-Lim under ``griffinlim``; the deployable
    regimes composite in time (prediction inside the gap, the input
    outside)."""
    n_samples = audio.shape[-1]
    if phase == "oracle":
        return istft(torch.polar(out_mag, _phase_of(spec_clean)), length=n_samples, **kw)
    phase_gap = _phase_of(spec_gap)
    if phase == "impaired":
        rec = istft(torch.polar(out_mag, phase_gap), length=n_samples, **kw)
    else:
        # Phase-trust mask: stricter than the model's frame mask, a frame's
        # phase is kept only if its whole analysis window avoids the gap.
        trust = window_clear_frame_mask(sample_valid, out_mag.shape[-1], kw["hop_length"],
                                        kw["n_fft"], win_length=kw["win_length"])
        ext = extrapolate_phase(phase_gap, trust, kw["hop_length"], kw["n_fft"])
        if phase == "extrapolate":
            rec = istft(torch.polar(out_mag, ext), length=n_samples, **kw)
        else:  # griffinlim, warm-started from the extrapolated estimate
            rec = griffinlim(out_mag, n_iter=gl_iters, init="given", init_phase=ext,
                             length=n_samples, **kw)
    return audio * sample_valid + rec * (1.0 - sample_valid)


@contextlib.contextmanager
def _eval_mode(module: torch.nn.Module):
    """``module`` in eval mode inside, the caller's mode restored after."""
    was_training = module.training
    module.eval()
    try:
        yield
    finally:
        module.train(was_training)


def _generator_fn(generator: torch.nn.Module, compute_dtype: Optional[torch.dtype]) -> Callable:
    """``apply(log_impaired, fmask) -> generated`` in f32: the generator in
    eval mode (the caller's mode restored after), or its bf16 copy made here
    once with bf16 inputs."""
    net = generator if compute_dtype is None else copy.deepcopy(generator).to(compute_dtype).eval()

    def apply(log_impaired: torch.Tensor, fmask: torch.Tensor) -> torch.Tensor:
        in_dtype = compute_dtype or log_impaired.dtype
        with _eval_mode(generator):
            return net(log_impaired.to(in_dtype), fmask.to(in_dtype)).to(log_impaired.dtype)

    return apply


def _gan_magnitude(generated: torch.Tensor, ref_spec: torch.Tensor, fmask: torch.Tensor,
                   mode: str) -> torch.Tensor:
    if mode == "parity":
        return generated  # the reference feeds the log1p-domain output directly
    composited = masking.composite(generated, masking.log1p_norm(ref_spec.abs()), fmask)
    return masking.log1p_denorm(composited)


def make_gan_inpaint_fn(
    cfg: Config,
    generator: torch.nn.Module,
    mode: str = "parity",
    compute_dtype: Optional[torch.dtype] = None,
    phase: str = "oracle",
    gl_iters: int = 64,
) -> Callable:
    """``fn(audio, gap_start, gap_len) -> (restored, generated)``.

    ``audio`` is ``(B, S)`` clean f32 waveforms; ``gap_start``/``gap_len``
    are ``(B,)`` integer sample counts on the same device; the gap is zeroed
    inside.  Frames ``[start // hop, ceil(end / hop))`` of the interval are
    holes, as in the JAX function, also where the gap runs past the clip's
    end.  ``restored`` is ``(B, S)``; ``generated`` is the generator's ``(B,
    F, N)`` output (log1p domain, in [-1, 1]) in f32.  ``gl_iters`` is
    Griffin-Lim's iteration count under ``phase="griffinlim"``.

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
    serve, kw = _gan_serve_fn(cfg, generator, mode, phase, gl_iters, compute_dtype)

    @torch.inference_mode()
    def fn(
        audio: torch.Tensor, gap_start: torch.Tensor, gap_len: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        n_bins, n_frames = _frame_shape(kw, audio.shape[-1])
        fmask = frame_mask_from_interval(gap_start, gap_start + gap_len, n_bins, n_frames,
                                         kw["hop_length"], dtype=audio.dtype)
        return serve(audio, gap_mask(audio.shape[-1], gap_start, gap_len, dtype=audio.dtype),
                     fmask)

    return fn


def _frame_shape(kw: dict, n_samples: int) -> Tuple[int, int]:
    return kw["n_fft"] // 2 + 1, 1 + n_samples // kw["hop_length"]


def _gan_serve_fn(cfg: Config, generator: torch.nn.Module, mode: str, phase: str,
                  gl_iters: int, compute_dtype: Optional[torch.dtype]) -> Tuple[Callable, dict]:
    """``(serve(audio, sample_mask, fmask) -> (restored, generated), kw)``:
    the GAN's request from its 1 = valid sample mask and frame mask."""
    _check_gan(mode, phase, compute_dtype)
    apply = _generator_fn(generator, compute_dtype)
    kw = _spec_kw(cfg)

    def serve(audio: torch.Tensor, sample_mask: torch.Tensor,
              fmask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        spec_clean = stft(audio, **kw)
        spec_gap = stft(audio * sample_mask, **kw)
        generated = apply(masking.log1p_norm(spec_gap.abs()), fmask)
        out_mag = _gan_magnitude(generated, spec_clean if phase == "oracle" else spec_gap,
                                 fmask, mode)
        restored = _reconstruct(out_mag, spec_clean, spec_gap, audio, sample_mask, phase,
                                gl_iters, kw)
        return restored, generated

    return serve, kw


def make_gan_inpaint_mask_fn(
    cfg: Config,
    generator: torch.nn.Module,
    mode: str = "enhanced",
    phase: str = "oracle",
    gl_iters: int = 64,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable:
    """``fn(audio, sample_mask) -> (restored, generated)``: GAN serving
    driven by any 1 = valid ``(B, S)`` time-domain mask, every gap of a clip
    in one forward pass.  A frame is a hole if any sample of its hop is
    missing (``frame_mask_from_sample_mask(rule="any")``, the floor/ceil rule
    for one interval that ends inside the clip).  ``mode``, ``phase``,
    ``gl_iters`` and ``compute_dtype`` as in :func:`make_gan_inpaint_fn`."""
    serve, kw = _gan_serve_fn(cfg, generator, mode, phase, gl_iters, compute_dtype)

    @torch.inference_mode()
    def fn(audio: torch.Tensor, sample_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        sample_mask = sample_mask.to(audio.dtype)
        fmask = frame_mask_from_sample_mask(sample_mask, *_frame_shape(kw, audio.shape[-1]),
                                            kw["hop_length"], rule="any", dtype=audio.dtype)
        return serve(audio, sample_mask, fmask)

    return fn


def _cnn_serve(model: torch.nn.Module, audio: torch.Tensor, sample_valid: torch.Tensor,
               gmask: torch.Tensor, phase: str, gl_iters: int,
               kw: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CNN+BiLSTM's request from its frame gap mask ``gmask`` (``(B, F,
    N)``, 1 = gap): under ``oracle`` the reference protocol (the clean STFT
    with the gap frames zeroed), else everything from the gapped waveform."""
    spec_clean = stft(audio, **kw) if phase == "oracle" else None
    spec_gap = None if phase == "oracle" else stft(audio * sample_valid, **kw)
    base = spec_clean if phase == "oracle" else spec_gap
    log_impaired = torch.log10(base.abs() * (1.0 - gmask) + masking.LOG10_EPS)
    with _eval_mode(model):
        pred = model(log_impaired)
    composited = pred * gmask + log_impaired * (1.0 - gmask)
    out_mag = masking.log10_denorm(composited)
    restored = _reconstruct(out_mag, spec_clean, spec_gap, audio, sample_valid, phase, gl_iters,
                            kw)
    return restored, composited


def make_cnn_inpaint_fn(cfg: Config, model: torch.nn.Module, phase: str = "oracle",
                        gl_iters: int = 64) -> Callable:
    """``fn(audio, gap_start, gap_len) -> (restored, composited)``.

    ``audio`` is ``(B, S)`` clean waveforms; ``gap_start``/``gap_len`` are
    ``(B,)`` integer sample counts on the same device.  ``restored`` is
    ``(B, S)``; ``composited`` is the ``(B, F, N)`` log10 magnitude with the
    prediction inside the gap frames ``[start // hop, (start + len) // hop)``
    (the floor rule at both ends, as in the JAX function, also where the gap
    runs past the clip's end).  The model's weights stay in ``model``.  The
    model is applied in eval mode (BatchNorm's running statistics, left as
    they are), as the JAX function applies it with ``train=False``, whatever
    mode the caller left it in; that mode is restored after.  ``gl_iters``
    as in :func:`make_gan_inpaint_fn`.
    """
    _check_phase(phase)
    kw = _spec_kw(cfg)

    @torch.inference_mode()
    def fn(
        audio: torch.Tensor, gap_start: torch.Tensor, gap_len: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        gmask = _cnn_gap_frames(kw, audio, gap_start, gap_len)
        tmask = gap_mask(audio.shape[-1], gap_start, gap_len, dtype=audio.dtype)
        return _cnn_serve(model, audio, tmask, gmask, phase, gl_iters, kw)

    return fn


def _cnn_gap_frames(kw: dict, audio: torch.Tensor, gap_start: torch.Tensor,
                    gap_len: torch.Tensor) -> torch.Tensor:
    """``(B, F, N)`` frame gap mask (1 = gap) of one interval a clip, the
    floor rule at both ends: frames ``[start // hop, (start + len) //
    hop)``."""
    hop = kw["hop_length"]
    n_bins, n_frames = _frame_shape(kw, audio.shape[-1])
    t = torch.arange(n_frames, device=audio.device)
    hole = (t >= (gap_start // hop)[..., None]) & (t < ((gap_start + gap_len) // hop)[..., None])
    return hole.to(audio.dtype)[..., None, :].expand(*hole.shape[:-1], n_bins, n_frames)


def make_cnn_phase_inpaint_fn(cfg: Config, model: torch.nn.Module,
                              anchored: bool = False) -> Callable:
    """``fn(audio, gap_start, gap_len) -> (restored, composited)`` for the
    phase-mode (complex 2-channel) CNN+BiLSTM (``inference.py:349-413``).

    The model takes the gapped waveform's STFT as real and imaginary
    channels and predicts the complex spectrogram, magnitude and phase, so
    no phase regime applies: everything comes from the gapped waveform.  Its
    prediction is composited into the gap frames (the floor rule at both
    ends, as the training features), the gapped STFT kept elsewhere, the
    iSTFT taken, and the input kept outside the gap in time, bit for bit.
    ``composited`` is the complex ``(B, F, N)`` spectrogram.

    ``anchored`` serves a model trained on the anchor-rotated target
    (``cnn_phase_features(anchored=True)``): its output is multiplied by
    ``exp(+i phi)``, ``phi`` the phase-vocoder extrapolation of the gapped
    STFT's phase over the frames whose window touches the gap, computed as
    in training.  The model runs in eval mode; the caller's mode is
    restored after."""
    kw = _spec_kw(cfg)

    @torch.inference_mode()
    def fn(
        audio: torch.Tensor, gap_start: torch.Tensor, gap_len: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        n_samples = audio.shape[-1]
        tmask = gap_mask(n_samples, gap_start, gap_len, dtype=audio.dtype)
        spec_gap = stft(audio * tmask, **kw)
        gmask = _cnn_gap_frames(kw, audio, gap_start, gap_len)
        with _eval_mode(model):
            pred = model(torch.stack([spec_gap.real, spec_gap.imag], dim=-1))
        pred_c = torch.complex(pred[..., 0], pred[..., 1])
        if anchored:
            clear = window_clear_frame_mask(tmask, spec_gap.shape[-1], kw["hop_length"],
                                            kw["n_fft"], win_length=kw["win_length"])
            phi = extrapolate_phase(torch.angle(spec_gap), clear, kw["hop_length"], kw["n_fft"])
            pred_c = pred_c * torch.polar(torch.ones_like(phi), phi)
        composited = pred_c * gmask + spec_gap * (1.0 - gmask)
        rec = istft(composited, length=n_samples, **kw)
        return audio * tmask + rec * (1.0 - tmask), composited

    return fn


def make_cnn_inpaint_mask_fn(cfg: Config, model: torch.nn.Module, phase: str = "oracle",
                             gl_iters: int = 64) -> Callable:
    """``fn(audio, sample_mask) -> (restored, composited)``: CNN+BiLSTM
    serving driven by any 1 = valid ``(B, S)`` mask, every gap in one pass.
    A frame is a gap frame if the last sample of its hop is missing
    (``rule="end"``, the floor/floor rule for one interval that ends inside
    the clip); otherwise as
    :func:`make_cnn_inpaint_fn`."""
    _check_phase(phase)
    kw = _spec_kw(cfg)

    @torch.inference_mode()
    def fn(audio: torch.Tensor, sample_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        sample_mask = sample_mask.to(audio.dtype)
        valid = frame_mask_from_sample_mask(sample_mask, *_frame_shape(kw, audio.shape[-1]),
                                            kw["hop_length"], rule="end", dtype=audio.dtype)
        return _cnn_serve(model, audio, sample_mask, 1.0 - valid, phase, gl_iters, kw)

    return fn


def make_tta_shift_fn(inpaint_fn: Callable, hop_length: int, n_shifts: int) -> Callable:
    """A test-time ensemble of sub-hop shifts around ``inpaint_fn(audio,
    gap_start, gap_len) -> (restored, aux)``: ``fn(audio, gap_start,
    gap_len) -> (restored, aux of the unshifted call)``.

    The STFT grid repeats only every ``hop_length`` samples, so a shift by
    ``s < hop`` frames the same gap differently.  Each of ``n_shifts``
    evenly spaced shifts ``round(i * hop / n_shifts)`` rolls the clip left by
    ``s`` (``torch.roll``; the gap start becomes ``gap_start - s``, which may
    lie below 0 for a gap at the clip's start: the gap then covers ``[0,
    gap_start + gap_len - s)``), inpaints, rolls back; the mean is kept
    inside the gap and the input outside it, bit for bit.  The wrap-around
    touches only the clip's first and last ``s`` samples.
    """
    if n_shifts < 1:
        raise ValueError(f"n_shifts must be >= 1, got {n_shifts}")
    shifts = [int(round(i * hop_length / n_shifts)) for i in range(n_shifts)]

    @torch.inference_mode()
    def fn(audio: torch.Tensor, gap_start: torch.Tensor,
           gap_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        acc, aux0 = None, None
        for s in shifts:
            out, aux = inpaint_fn(torch.roll(audio, -s, dims=-1), gap_start - s, gap_len)
            out = torch.roll(out, s, dims=-1)
            acc = out if acc is None else acc + out
            if aux0 is None:
                aux0 = aux
        avg = acc / float(len(shifts))
        tmask = gap_mask(audio.shape[-1], gap_start, gap_len, dtype=audio.dtype)
        return audio * tmask + avg * (1.0 - tmask), aux0

    return fn

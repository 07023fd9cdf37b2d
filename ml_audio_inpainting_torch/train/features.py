"""Training features of both families: waveforms and gap positions -> model
batches (port of ``ml_audio_inpainting_tpu/train/features.py::gan_features``,
``cnn_features`` and the phase-mode CNN's ``cnn_phase_features``).

The JAX function draws the gap positions from a ``jax.random`` key inside
the step; this one takes them as explicit tensors, ``(B, G)`` starts of one
gap a variant or ``(B, G, K)`` starts and lengths of K gaps a variant (a
``torch.Generator`` cannot reproduce ``jax.random``'s stream, and the tests
feed both packages the same positions).  As there, the clean STFT is
computed once per clip and shared by its G gap variants.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ml_audio_inpainting_torch.data.multigap import gaps_mask
from ml_audio_inpainting_torch.ops import masking
from ml_audio_inpainting_torch.ops.gaps import (
    frame_mask_from_interval,
    frame_mask_from_sample_mask,
    gap_mask,
)
from ml_audio_inpainting_torch.ops.phase import extrapolate_phase, window_clear_frame_mask
from ml_audio_inpainting_torch.ops.stft import stft
from ml_audio_inpainting_torch.utils.config import SpectrogramConfig

__all__ = ["gan_features", "cnn_features", "cnn_phase_features"]


def gan_features(
    audio: torch.Tensor,
    gap_start: torch.Tensor,
    spec: SpectrogramConfig,
    gap_len_s: float = 0.2,
    sample_rate: int = 16000,
    n_gaps: int = 1,
    gap_len: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """GAN batch features of ``audio (B, S)``, each ``(B, F, N)``:

    * ``original_magnitude`` ``log1p(|STFT(clean)|)``;
    * ``impaired_magnitude`` ``log1p(|STFT(clean * mask)|)``;
    * ``mask``               1 = valid frame, 0 = hole;
    * ``original_phase``     ``angle(STFT(clean))``.

    With ``n_gaps == 1``, ``gap_start (B,)`` holds integer starts of one gap
    of ``int(gap_len_s * sample_rate)`` samples (``random_gap_mask``'s
    rule: a gap of length 0 or less is none, one as long as the clip or
    longer is the whole clip, and then ``gap_start`` is not read); frames
    ``[start // hop, ceil(end / hop))`` are holes.  With ``n_gaps > 1``,
    ``gap_start`` and ``gap_len`` are ``(B, n_gaps)`` integer starts and
    lengths (``data/multigap.py``'s layout), and a frame is a hole when it
    is one for any of its clip's gaps (the minimum of the per-gap masks,
    ``features.py:83-95``).
    """
    B, S = audio.shape
    kw = dict(n_fft=spec.n_fft, hop_length=spec.hop_length, win_length=spec.win_length)
    start = gap_start.to(device=audio.device, dtype=torch.int64)
    if n_gaps == 1:
        length = int(gap_len_s * sample_rate)
        if length <= 0 or length >= S:
            start = torch.zeros_like(start)
            length = 0 if length <= 0 else S
        end = start + length
        masks = gap_mask(S, start, end - start, dtype=audio.dtype)  # (B, S)
    else:
        if gap_len is None or tuple(gap_start.shape) != (B, n_gaps) or (
                gap_len.shape != gap_start.shape):
            raise ValueError(f"n_gaps={n_gaps} takes (B, {n_gaps}) gap_start and gap_len, got "
                             f"{tuple(gap_start.shape)} and "
                             f"{None if gap_len is None else tuple(gap_len.shape)}")
        end = start + gap_len.to(device=audio.device, dtype=torch.int64)
        masks = gaps_mask(S, start, end - start, dtype=audio.dtype)  # (B, S)

    spec_clean = stft(audio, **kw)
    F, N = spec_clean.shape[-2:]
    frame_masks = frame_mask_from_interval(start, end, F, N, spec.hop_length, dtype=audio.dtype)
    if n_gaps > 1:
        frame_masks = frame_masks.amin(dim=1)  # (B, K, F, N) -> (B, F, N)
    return {
        "original_magnitude": masking.log1p_norm(spec_clean.abs()),
        "impaired_magnitude": masking.log1p_norm(stft(audio * masks, **kw).abs()),
        "mask": frame_masks,
        "original_phase": torch.angle(spec_clean),
    }


def cnn_features(
    audio: torch.Tensor,
    gap_start: torch.Tensor,
    spec: SpectrogramConfig,
    gap_len_s: float = 0.2,
    sample_rate: int = 16000,
    n_gaps: int = 1,
    gap_len: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """CNN+BiLSTM batch features for ``audio (B, S)``: each clip becomes G
    variants, variants of a clip adjacent.  Returns, each ``(B*G, F, N)``:

    * ``log_gap``    ``log10(|STFT(gapped)| + 1e-9)``, the model input;
    * ``gap_mask``   1 = gap frame, 0 = valid;
    * ``target_mag`` ``|STFT(clean)|``, repeated for each variant.

    With ``n_gaps == 1``, ``gap_start (B, G)`` holds integer sample
    positions: variant ``g`` of clip ``b`` has a gap of ``int(gap_len_s *
    sample_rate)`` samples at ``gap_start[b, g]`` (ending at the clip's end
    at the latest).  With ``n_gaps > 1``, ``gap_start`` and ``gap_len`` are
    ``(B, G, n_gaps)`` integer starts and lengths, as ``data/multigap.py``
    lays them out.  A frame is a hole when its last sample is
    (``frame_mask_from_sample_mask``'s ``"end"`` rule, ``features.py:148-161``),
    which for one gap ``[s, e)`` is the floor rule at both ends, frames
    ``[s // hop, e // hop)`` (``features.py:162-168``).
    """
    B, S = audio.shape
    G = gap_start.shape[1]
    masks = _variant_masks(audio, gap_start, gap_len_s, sample_rate, n_gaps, gap_len)
    spec_clean, spec_gap, gmask = _variant_spectra(audio, masks, spec)
    F, N = spec_clean.shape[-2:]
    return {
        "log_gap": masking.log10_norm(spec_gap.abs()).reshape(B * G, F, N),
        "gap_mask": gmask.reshape(B * G, F, N),
        "target_mag": spec_clean.abs().repeat_interleave(G, dim=0),
    }


def _variant_masks(audio: torch.Tensor, gap_start: torch.Tensor, gap_len_s: float,
                   sample_rate: int, n_gaps: int,
                   gap_len: Optional[torch.Tensor]) -> torch.Tensor:
    """``(B, G, S)`` sample masks (1 = valid) of the CNN+BiLSTM's G gap
    variants a clip, as :func:`cnn_features` lays them out."""
    B, S = audio.shape
    G = gap_start.shape[1]
    start = gap_start.to(device=audio.device, dtype=torch.int64)
    if n_gaps == 1:
        length = int(gap_len_s * sample_rate)
        end = torch.clamp(start + max(length, 0), max=S)
        return gap_mask(S, start, end - start, dtype=audio.dtype)
    if gap_len is None or tuple(gap_start.shape) != (B, G, n_gaps) or (
            gap_len.shape != gap_start.shape):
        raise ValueError(f"n_gaps={n_gaps} takes (B, G, {n_gaps}) gap_start and gap_len, "
                         f"got {tuple(gap_start.shape)} and "
                         f"{None if gap_len is None else tuple(gap_len.shape)}")
    return gaps_mask(S, start, gap_len.to(device=audio.device, dtype=torch.int64),
                     dtype=audio.dtype)


def _variant_spectra(audio: torch.Tensor, masks: torch.Tensor, spec: SpectrogramConfig):
    """``(STFT(clean) (B, F, N), STFT(gapped) (B, G, F, N), gap frames (B,
    G, F, N))``: the clean STFT once a clip, a frame a gap frame when its
    last sample is missing (``rule="end"``)."""
    kw = dict(n_fft=spec.n_fft, hop_length=spec.hop_length, win_length=spec.win_length)
    spec_clean = stft(audio, **kw)
    F, N = spec_clean.shape[-2:]
    spec_gap = stft(audio[:, None] * masks, **kw)
    gmask = 1.0 - frame_mask_from_sample_mask(masks, F, N, spec.hop_length, rule="end",
                                              dtype=audio.dtype)
    return spec_clean, spec_gap, gmask


def cnn_phase_features(
    audio: torch.Tensor,
    gap_start: torch.Tensor,
    spec: SpectrogramConfig,
    gap_len_s: float = 0.2,
    sample_rate: int = 16000,
    anchored: bool = False,
) -> Dict[str, torch.Tensor]:
    """Phase-mode CNN+BiLSTM features (``features.py:198-290``): one gap a
    variant, ``gap_start (B, G)`` as for :func:`cnn_features` with
    ``n_gaps == 1`` (the phase pipeline has no multi-gap form).  Returns:

    * ``spec_gap`` ``(B*G, F, N, 2)``, the real and imaginary parts of
      STFT(gapped), the raw (unnormalised) model input;
    * ``gap_mask`` ``(B*G, F, N)``, 1 = gap frame (the floor rule at both
      ends);
    * ``target``   ``(B*G, F, N)`` complex STFT(clean), repeated for each
      variant; with ``anchored`` rotated by ``exp(-i phi)``, ``phi`` the
      phase-vocoder extrapolation of the gapped STFT's phase
      (``ops/phase.py::extrapolate_phase``) over the frames whose window
      touches the gap, the deployable anchor that serving multiplies back
      (``runtime/inference.py::make_cnn_phase_inpaint_fn``).
    """
    B, S = audio.shape
    G = gap_start.shape[1]
    masks = _variant_masks(audio, gap_start, gap_len_s, sample_rate, 1, None)
    spec_clean, spec_gap, gmask = _variant_spectra(audio, masks, spec)
    F, N = spec_clean.shape[-2:]
    spec_gap = spec_gap.reshape(B * G, F, N)
    target = spec_clean.repeat_interleave(G, dim=0)
    if anchored:
        clear = window_clear_frame_mask(masks.reshape(B * G, S), N, spec.hop_length, spec.n_fft,
                                        win_length=spec.win_length)
        phi = extrapolate_phase(torch.atan2(spec_gap.imag, spec_gap.real), clear,
                                spec.hop_length, spec.n_fft)
        target = target * torch.polar(torch.ones_like(phi), -phi)
    return {
        "spec_gap": torch.stack([spec_gap.real, spec_gap.imag], dim=-1),
        "gap_mask": gmask.reshape(B * G, F, N),
        "target": target,
    }

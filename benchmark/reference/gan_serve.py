"""Plain GAN serving of one request, as a user receives it: the gap zeroed,
the gapped clip's STFT, ``log1p`` of its magnitude, the generator on it
with the frame mask (frames ``[start // hop, ceil(end / hop))`` are
holes), the generator's output composited into the hole frames and
``expm1``; the gapped clip's phase with every frame whose window touches
the gap extrapolated from both sides; the inverse STFT; the clip
composited in time; the PCM16 patch of ``window`` samples around the gap.
"""

from __future__ import annotations

import torch

from benchmark.reference import dsp, pconv_unet


def serve(sd, cfg: dict, audio: torch.Tensor, gap_start: torch.Tensor, gap_len: torch.Tensor,
          window: int, q=pconv_unet._identity):
    """``(patch (B, window) int16, start (B,))`` of ``audio (B, S)`` with one
    gap a clip, in ``audio``'s dtype; ``q`` as :func:`pconv_unet.forward`."""
    n_fft, hop, wl = cfg["n_fft"], cfg["hop_length"], cfg["win_length"]
    s = audio.shape[-1]
    valid = dsp.gap_mask(s, gap_start, gap_len, audio.dtype)
    spec = dsp.stft(audio * valid, n_fft, hop, wl)
    n_frames = spec.shape[-1]
    holes = dsp.hole_frames_interval(gap_start, gap_start + gap_len, n_frames, hop)
    fmask = (~holes).to(audio.dtype)[:, None, :].expand_as(spec.real)
    log_mag = torch.log1p(spec.abs())
    generated = pconv_unet.forward(sd, log_mag, fmask, cfg["enc_layer_cfg"], cfg["dec_layer_cfg"], q)
    mag = torch.expm1(log_mag * fmask + generated * (1.0 - fmask))
    trusted = dsp.window_clear(valid, n_frames, hop, wl)
    phase = dsp.extrapolate_phase(dsp.phase_of(spec), trusted, hop, n_fft)
    rebuilt = dsp.istft(torch.polar(mag, phase), n_fft, hop, wl, s)
    return dsp.patch_of(audio, valid, rebuilt, gap_start, window)

"""Plain CNN+BiLSTM serving of one request, as a user receives it: the gap
zeroed, the gapped clip's STFT, ``log10`` of its magnitude with the gap
frames (``[start // hop, (start + len) // hop)``) zeroed before the log
(plus 1e-9), the model on it, its prediction composited into the gap
frames and ``10 ** x``; the gapped clip's phase with every frame whose
window touches the gap extrapolated from both sides; the inverse STFT; the
clip composited in time; the PCM16 patch of ``window`` samples around the
gap.
"""

from __future__ import annotations

import torch

from benchmark.reference import cnn_blstm, dsp


def serve(sd, cfg: dict, audio: torch.Tensor, gap_start: torch.Tensor, gap_len: torch.Tensor,
          window: int, q=cnn_blstm._identity):
    """``(patch (B, window) int16, start (B,))`` of ``audio (B, S)`` with one
    gap a clip, in ``audio``'s dtype; ``q`` as :func:`cnn_blstm.forward`."""
    n_fft, hop, wl = cfg["n_fft"], cfg["hop_length"], cfg["win_length"]
    s = audio.shape[-1]
    valid = dsp.gap_mask(s, gap_start, gap_len, audio.dtype)
    spec = dsp.stft(audio * valid, n_fft, hop, wl)
    n_frames = spec.shape[-1]
    t = torch.arange(n_frames, device=audio.device)
    gap = ((t >= (gap_start // hop)[:, None]) & (t < ((gap_start + gap_len) // hop)[:, None]))
    gmask = gap.to(audio.dtype)[:, None, :].expand_as(spec.real)
    log_in = torch.log10(spec.abs() * (1.0 - gmask) + 1e-9)
    pred = cnn_blstm.forward(sd, log_in, cfg["num_lstm_layers"], len(cfg["enc_filters"]) + 1, q)
    mag = torch.pow(10.0, pred * gmask + log_in * (1.0 - gmask))
    trusted = dsp.window_clear(valid, n_frames, hop, wl)
    phase = dsp.extrapolate_phase(dsp.phase_of(spec), trusted, hop, n_fft)
    rebuilt = dsp.istft(torch.polar(mag, phase), n_fft, hop, wl, s)
    return dsp.patch_of(audio, valid, rebuilt, gap_start, window)

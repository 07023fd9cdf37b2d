"""Plain CNN+BiLSTM training steps: the published recipe's features, the
model in train mode (BatchNorm's batch statistics), the gap L1 loss, the
backward pass through the plain recurrence by autograd, and Adam (optax's
defaults: b1 0.9, b2 0.999, eps 1e-8 outside the square root), in f32.

Features of ``(B, S)`` clips and ``(B, G, K)`` gap starts and lengths (G
variants a clip, K gaps a variant): each variant's gapped clip, the log10
of its STFT magnitude (plus 1e-9) as the input; a frame is a gap frame
when its last sample is missing; the target is the clean clip's STFT
magnitude.  The loss is the sum over the gap frames of ``|10 ** pred -
target|``.
"""

from __future__ import annotations

import torch

from benchmark.reference import cnn_blstm, dsp, quant

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")
BETAS, EPS = (0.9, 0.999), 1e-8


def leaves(sd: dict) -> list:
    return [k for k in sd if not k.endswith(BUFFERS)]


def features(audio, starts, lengths, rc: dict):
    b, s = audio.shape
    g, k = starts.shape[1], starts.shape[2]
    n_fft, hop, wl = rc["n_fft"], rc["hop_length"], rc["win_length"]
    valid = dsp.gap_mask(s, starts.reshape(b * g, k), lengths.reshape(b * g, k), audio.dtype)
    clean = dsp.stft(audio, n_fft, hop, wl)
    gapped = dsp.stft(audio.repeat_interleave(g, dim=0) * valid, n_fft, hop, wl)
    holes = dsp.hole_frames_end_rule(valid, clean.shape[-1], hop)
    gmask = holes.to(audio.dtype)[:, None, :].expand_as(gapped.real)
    return torch.log10(gapped.abs() + 1e-9), gmask, clean.abs().repeat_interleave(g, dim=0)


def loss_of(pred, gmask, target):
    return torch.sum(torch.abs(torch.pow(10.0, pred) * gmask - target * gmask))


def train(sd0: dict, rc: dict, batches, lr: float, q=quant.identity, half: bool = False,
          dtype=None) -> dict:
    """Follow ``batches`` (``(audio, [starts, lengths])`` a step) from the
    weights ``sd0``: each step's loss, the first step's gradients, and the
    parameters after the last step.  With ``dtype`` the network runs on casts
    of the f32 parameters and input to it (BatchNorm's statistics and the
    loss stay f32)."""
    params = {k: sd0[k].detach().clone().requires_grad_(True) for k in leaves(sd0)}
    buffers = {k: sd0[k] for k in sd0 if k not in params}
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=BETAS, eps=EPS)
    losses, first = [], None
    n_enc = len(rc["enc_filters"]) + 1
    for audio, (starts, lengths) in batches:
        if half:
            cut = audio.shape[0] // 2
            audio, starts, lengths = audio[:cut], starts[:cut], lengths[:cut]
        with torch.no_grad():
            x, gmask, target = features(audio, starts, lengths, rc)
        net = {k: v.to(dtype) for k, v in params.items()} if dtype else params
        pred = cnn_blstm.forward({**net, **buffers}, x.to(dtype or x.dtype), rc["num_lstm_layers"],
                                 n_enc, q, train=True)
        loss = loss_of(pred.float(), gmask, target)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if first is None:
            first = {k: p.grad.detach().clone() for k, p in params.items()}
        opt.step()
        losses.append(loss.detach())
    return {"losses": losses, "first": first,
            "after": {k: p.detach().clone() for k, p in params.items()}}

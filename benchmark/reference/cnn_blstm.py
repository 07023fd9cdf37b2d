"""Plain forward pass of the CNN+BiLSTM (the CNN+BiLSTM family), from a
state dict: the yardstick's frozen form of the published architecture.

``(B, F, T)`` log10 magnitude -> encoder (3x3 SAME convolutions with bias,
BatchNorm eps 1e-5, ReLU) -> the ``(B, C, F, T)`` features read in the
published model's NHWC order as a ``(B, T, C * F)`` sequence -> a stacked
BiLSTM (gates i, f, g, o; ``x @ W_ih + b`` and ``h @ W_hh`` with ``(in,
4H)`` weights; from ``h = c = 0``; forward and backward directions
concatenated) -> a dense projection to ``dec0 * F`` read back as ``(B,
dec0, F, T)`` -> decoder (two convolution, BatchNorm, ReLU blocks, then a
1-channel convolution).

The recurrence is a Python loop over time, one ``(B, H) x (H, 4H)``
product a step.  ``q`` is applied to the inputs and weights of every
convolution and matrix product (the identity by default); ``train`` takes
BatchNorm's batch statistics by flax's rule.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.pconv_unet import batch_norm


def _identity(x):
    return x


def lstm_direction(xw: torch.Tensor, w_hh: torch.Tensor, reverse: bool,
                   q: Callable = _identity) -> torch.Tensor:
    """``(B, T, 4H)`` projected inputs -> ``h (B, T, H)`` in input order."""
    b, t_len, _ = xw.shape
    hdim = w_hh.shape[0]
    h = xw.new_zeros((b, hdim))
    c = xw.new_zeros((b, hdim))
    w = q(w_hh)
    out = [None] * t_len
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        gates = xw[:, t] + q(h) @ w
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h
    return torch.stack(out, dim=1)


def forward(sd: Dict[str, torch.Tensor], x: torch.Tensor, num_layers: int,
            n_enc: int, q: Callable = _identity, train: bool = False,
            stats: Optional[dict] = None) -> torch.Tensor:
    h = x[:, None]
    b, _, n_freq, t_len = h.shape
    for i in range(n_enc):
        h = F.conv2d(q(h), q(sd[f"enc_conv{i}.weight"]), sd[f"enc_conv{i}.bias"], padding=1)
        h = torch.relu(batch_norm(h, sd, f"enc_bn{i}", train, stats))
    seq = h.permute(0, 3, 1, 2).reshape(b, t_len, -1)
    for layer in range(num_layers):
        outs = []
        for direction in ("fwd", "bwd"):
            name = f"lstm.l{layer}_{direction}"
            xw = q(seq) @ q(sd[f"{name}_w_ih"]) + sd[f"{name}_b"]
            outs.append(lstm_direction(xw, sd[f"{name}_w_hh"], direction == "bwd", q))
        seq = torch.cat(outs, dim=-1)
    seq = q(seq) @ q(sd["projection.weight"]).t() + sd["projection.bias"]
    dec0 = sd["dec_conv0.weight"].shape[1]
    h = seq.reshape(b, t_len, dec0, n_freq).permute(0, 2, 3, 1)
    for i in range(2):
        h = F.conv2d(q(h), q(sd[f"dec_conv{i}.weight"]), sd[f"dec_conv{i}.bias"], padding=1)
        h = torch.relu(batch_norm(h, sd, f"dec_bn{i}", train, stats))
    h = F.conv2d(q(h), q(sd["dec_conv2.weight"]), sd["dec_conv2.bias"], padding=1)
    return h[:, 0]


def param_shapes(freq_bins: int, enc_filters, dec_filters, hidden: int, num_layers: int,
                 in_channels: int = 1) -> Dict[str, tuple]:
    """Every tensor of the model's state dict, by the names the served
    module gives them (see :func:`pconv_unet.param_shapes`); the BiLSTM's
    ``("lstm_ih" | "lstm_hh", shape)`` and ``("zero", shape)`` biases."""
    out: Dict[str, tuple] = {}

    def conv(name, c_out, c_in):
        out[f"{name}.weight"] = ("conv", (c_out, c_in, 3, 3))
        out[f"{name}.bias"] = ("zero", (c_out,))

    def norm(prefix, ch):
        out.update({f"{prefix}.weight": ("one", (ch,)), f"{prefix}.bias": ("zero", (ch,)),
                    f"{prefix}.running_mean": ("zero", (ch,)),
                    f"{prefix}.running_var": ("one", (ch,)),
                    f"{prefix}.num_batches_tracked": ("count", ())})

    c_in = in_channels
    for i, ch in enumerate(list(enc_filters) + [hidden // 2]):
        conv(f"enc_conv{i}", ch, c_in)
        norm(f"enc_bn{i}", ch)
        c_in = ch
    for layer in range(num_layers):
        d_in = freq_bins * c_in if layer == 0 else 2 * hidden
        for direction in ("fwd", "bwd"):
            name = f"lstm.l{layer}_{direction}"
            out[f"{name}_w_ih"] = ("lstm_ih", (d_in, 4 * hidden))
            out[f"{name}_w_hh"] = ("lstm_hh", (hidden, 4 * hidden))
            out[f"{name}_b"] = ("zero", (4 * hidden,))
    out["projection.weight"] = ("dense", (freq_bins * dec_filters[0], 2 * hidden))
    out["projection.bias"] = ("zero", (freq_bins * dec_filters[0],))
    conv("dec_conv0", dec_filters[1], dec_filters[0])
    norm("dec_bn0", dec_filters[1])
    conv("dec_conv1", dec_filters[0], dec_filters[1])
    norm("dec_bn1", dec_filters[0])
    conv("dec_conv2", in_channels, dec_filters[0])
    return out

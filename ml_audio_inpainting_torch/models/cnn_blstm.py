"""CNN encoder -> BiLSTM bottleneck -> CNN decoder (port of
``ml_audio_inpainting_tpu/models/cnn_blstm.py::StackedBLSTMCNN``).

The convs run in NCHW with H = frequency and W = time; the public interface
stays ``(B, F, T)`` log spectrograms, as in the JAX model.  The JAX model
works in NHWC ``(B, F, T, C)``, so the two reshapes around the BiLSTM follow
its element order exactly:

* into the sequence, JAX flattens ``(B, F, T, C) -> (B, T, C, F) -> (B, T, C*F)``,
  so here ``(B, C, F, T) -> (B, T, C, F)`` before the flatten;
* out of the projection, JAX reads ``(B, T, C*F)`` as ``(B, T, C, F)`` and
  moves it to ``(B, F, T, C)``, so here ``(B, T, C, F) -> (B, C, F, T)``.

BatchNorm runs in inference mode with flax's eps 1e-5; a 3x3 SAME conv is
padding 1.  Serving only: the module is built in eval mode.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ml_audio_inpainting_torch.ops.lstm import BiLSTM

__all__ = ["StackedBLSTMCNN"]

BN_EPS = 1e-5  # flax.linen.BatchNorm default


class StackedBLSTMCNN(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        num_lstm_layers: int = 3,
        lstm_hidden_dim: int = 128,
        freq_bins: int = 257,
        enc_filters: Sequence[int] = (16, 32),
        dec_filters: Sequence[int] = (16, 32),
        global_pool: bool = False,
    ):
        super().__init__()
        if in_channels != 1:
            raise NotImplementedError(
                "in_channels=2 (phase-mode CNN) waits for the phase-mode slice of the port"
            )
        if global_pool:
            raise NotImplementedError(
                "global_pool (v2-era frequency mean-pool) waits for a later slice of the port"
            )
        self.dec_filters = tuple(dec_filters)
        enc_channels = list(enc_filters) + [lstm_hidden_dim // 2]
        c_in = in_channels
        for i, ch in enumerate(enc_channels):
            self.add_module(f"enc_conv{i}", nn.Conv2d(c_in, ch, 3, padding=1))
            self.add_module(f"enc_bn{i}", nn.BatchNorm2d(ch, eps=BN_EPS))
            c_in = ch
        self.num_enc = len(enc_channels)
        self.lstm = BiLSTM(freq_bins * c_in, lstm_hidden_dim, num_lstm_layers)
        self.projection = nn.Linear(2 * lstm_hidden_dim, freq_bins * self.dec_filters[0])
        self.dec_conv0 = nn.Conv2d(self.dec_filters[0], self.dec_filters[1], 3, padding=1)
        self.dec_bn0 = nn.BatchNorm2d(self.dec_filters[1], eps=BN_EPS)
        self.dec_conv1 = nn.Conv2d(self.dec_filters[1], self.dec_filters[0], 3, padding=1)
        self.dec_bn1 = nn.BatchNorm2d(self.dec_filters[0], eps=BN_EPS)
        self.dec_conv2 = nn.Conv2d(self.dec_filters[0], in_channels, 3, padding=1)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, F, T)`` log spectrograms -> ``(B, F, T)``."""
        B, F, T = x.shape
        h = x[:, None]  # (B, 1, F, T)
        for i in range(self.num_enc):
            h = getattr(self, f"enc_conv{i}")(h)
            h = torch.relu(getattr(self, f"enc_bn{i}")(h))

        seq = h.permute(0, 3, 1, 2).reshape(B, T, -1)  # (B, T, C*F), JAX's order
        seq = self.lstm(seq)
        seq = self.projection(seq)  # (B, T, dec0*F)
        h = seq.reshape(B, T, self.dec_filters[0], F).permute(0, 2, 3, 1)  # (B, dec0, F, T)

        h = torch.relu(self.dec_bn0(self.dec_conv0(h)))
        h = torch.relu(self.dec_bn1(self.dec_conv1(h)))
        h = self.dec_conv2(h)
        return h[:, 0]

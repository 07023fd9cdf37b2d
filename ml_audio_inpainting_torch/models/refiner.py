"""The learned time-domain gap refiner (port of
``ml_audio_inpainting_tpu/models/refiner.py``).

``WaveRefiner`` is a dilated 1-D convolution stack over a window centred on
the gap.  Its four input channels are the impaired waveform (gap zeroed),
the AR extrapolation fill (``classical/arinpaint.py``), the GAN's
reconstruction under the extrapolated phase, and the gap indicator.  It
outputs a delta added to the AR fill inside the gap; the observed samples
pass through untouched.  The last projection starts at zero, so a fresh
head reproduces the AR fill exactly.

The boundary is flax's, ``(B, W)`` per channel in and ``(B, W)`` out; the
convolutions run NCW inside.  flax's ``padding="SAME"`` on 3 taps at
dilation ``d`` is ``d`` zeros on each side, and flax's ``nn.gelu`` is the
tanh approximation (``jax.nn.gelu(approximate=True)``), so this uses
``F.gelu(approximate="tanh")``.  Module names follow flax's (``Conv_0``,
``blocks.i`` for ``_DilatedBlock_i``, ``Conv_1``, ``Conv_2``) so that
``weights.py`` maps each one to its flax path.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ml_audio_inpainting_torch.models.cnn_blstm import _lecun_normal_

__all__ = ["WaveRefiner", "window_bounds", "DILATIONS"]

DILATIONS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 1, 2, 4, 8, 16, 32, 64, 128, 256)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu


class _DilatedBlock(nn.Module):
    """``x + Conv_1(gelu(Conv_0(x)))``, ``Conv_0`` 3 taps at ``dilation``."""

    def __init__(self, channels: int, dilation: int):
        super().__init__()
        self.Conv_0 = nn.Conv1d(channels, channels, 3, dilation=dilation, padding=dilation)
        self.Conv_1 = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.Conv_1(_gelu(self.Conv_0(x)))


class WaveRefiner(nn.Module):
    """Dilated residual convolution stack: four ``(B, W)`` channels in, the
    refined ``(B, W)`` window out.  The default dilations span a receptive
    field of ~4k samples, twice over."""

    def __init__(self, channels: int = 64, dilations: Sequence[int] = DILATIONS):
        super().__init__()
        self.channels = channels
        self.dilations = tuple(dilations)
        self.Conv_0 = nn.Conv1d(4, channels, 3, padding=1)
        self.blocks = nn.ModuleList(_DilatedBlock(channels, d) for d in self.dilations)
        self.Conv_1 = nn.Conv1d(channels, channels, 1)
        self.Conv_2 = nn.Conv1d(channels, 1, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "WaveRefiner":
        """flax's defaults from ``generator``: every kernel ``lecun_normal``
        (fan-in taps x input channels), biases zero, and the last projection
        zero, so the head starts as the identity on the AR fill.  (The JAX
        package draws from ``jax.random``; the numbers differ.)"""
        for module in self.modules():
            if isinstance(module, nn.Conv1d):
                _lecun_normal_(module.weight, module.weight[0].numel(), generator)
                module.bias.zero_()
        self.Conv_2.weight.zero_()
        return self

    def forward(self, impaired: torch.Tensor, ar_fill: torch.Tensor, neural: torch.Tensor,
                gap_ind: torch.Tensor) -> torch.Tensor:
        """``ar_fill + delta`` where ``gap_ind`` is 1, ``impaired`` where it
        is 0 (hard data consistency)."""
        h = self.Conv_0(torch.stack([impaired, ar_fill, neural, gap_ind], dim=1))
        for block in self.blocks:
            h = block(h)
        delta = self.Conv_2(_gelu(self.Conv_1(h)))[:, 0]
        refined = ar_fill + delta
        return impaired * (1.0 - gap_ind) + refined * gap_ind


def window_bounds(gap_start: torch.Tensor, gap_len: torch.Tensor, window: int, max_gap: int,
                  n_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(start, offset)``: the start of a ``window``-sample crop centred on
    the (padded) gap, with ``(window - max_gap) // 2`` samples of context on
    each side, clamped to the signal, and the gap's offset inside it."""
    ctx = (window - max_gap) // 2
    start = torch.clamp(gap_start - ctx, 0, n_samples - window)
    return start, gap_start - start

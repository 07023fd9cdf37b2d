"""Stacked bidirectional LSTM with hoisted input projections (port of
``ml_audio_inpainting_tpu/ops/lstm.py::BiLSTM``).

Per layer and direction, the input projection ``x @ W_ih + b`` for all
time steps is one large matmul (``torch.matmul``; the JAX package leaves it
to XLA, outside the kernel), and the recurrences of both directions over the
projected inputs run in one
:func:`~ml_audio_inpainting_torch.ops.cuda.lstm_cell.bilstm_recurrence` per
layer (one CUDA kernel launch on the card, its plain version on the CPU),
which writes the concatenated ``(B, T, 2H)`` output directly and is
differentiable (its backward is a kernel too).  Gate order is
torch's (i, f, g, o) with one summed bias; parameters keep the JAX names
``l{layer}_{fwd,bwd}_{w_ih,w_hh,b}`` and its ``(in, out)`` layouts.  On
bf16 parameters and input (the mixed-precision train step's casts) the
projection runs in bf16 and the recurrence through the bf16 form of the
kernels, as the JAX module runs with bf16 parameters.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ml_audio_inpainting_torch.ops.cuda.lstm_cell import bilstm_recurrence

__all__ = ["BiLSTM"]


class BiLSTM(nn.Module):
    """``(B, T, input_dim)`` -> ``(B, T, 2 * hidden_dim)`` (forward, backward
    concatenated).  Parameters start at zero: load weights, or draw them
    with :meth:`init_weights`."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 1):
        super().__init__()
        self.num_layers = num_layers
        self.hidden_dim = hidden_dim
        G = 4 * hidden_dim
        for layer in range(num_layers):
            d_in = input_dim if layer == 0 else 2 * hidden_dim
            for direction in ("fwd", "bwd"):
                name = f"l{layer}_{direction}"
                self.register_parameter(f"{name}_w_ih", nn.Parameter(torch.zeros(d_in, G)))
                self.register_parameter(f"{name}_w_hh", nn.Parameter(torch.zeros(hidden_dim, G)))
                self.register_parameter(f"{name}_b", nn.Parameter(torch.zeros(G)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX init's distributions (not its stream): both weight matrices
        from ``nn.initializers.uniform(scale=2/sqrt(H))``, which is U[0, 2/sqrt(H)),
        biases zero.  Draws on the CPU from ``generator``, then copies."""
        scale = 2.0 / math.sqrt(self.hidden_dim)
        for name, p in self.named_parameters():
            if name.endswith("_b"):
                p.zero_()
            else:
                p.copy_(torch.rand(p.shape, generator=generator) * scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in range(self.num_layers):
            args = []
            for direction in ("fwd", "bwd"):
                name = f"l{layer}_{direction}"
                xw = x @ getattr(self, f"{name}_w_ih") + getattr(self, f"{name}_b")
                args += [xw, getattr(self, f"{name}_w_hh")]
            x = bilstm_recurrence(*args)  # (B, T, 2H): forward, then backward
        return x

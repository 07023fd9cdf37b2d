"""The reference's earlier BLSTM models (port of
``ml_audio_inpainting_tpu/models/legacy_blstm.py``; the reference's
``models/CNNBLSTM/old/models_OLD.py``), on the port's
:class:`~ml_audio_inpainting_torch.ops.lstm.BiLSTM`, so on the card their
recurrences run through the ``lstm_fwd`` kernel and their backward through
``lstm_bwd`` and ``lstm_dwhh``:

* :class:`StackedBLSTM`        -- BiLSTM and a linear head over whole
  spectrogram columns (``models_OLD.py:16-60``);
* :class:`StackedBLSTMGapOnly` -- predicts only the gap columns through an
  FC 512 -> 128 -> gap_dim head (``models_OLD.py:87-127``);
* :class:`StackedNormBLSTM`    -- a LayerNorm after each bidirectional layer
  (``models_OLD.py:130-214``).

All take ``(B, T, audio_feat_dim)`` sequences of spectrogram columns and
apply dropout after the recurrence in train mode.  Modules carry the JAX
models' names (``blstm``, ``blstm{i}``, ``norm{i}``, ``fc``, ``fc1``...);
:func:`load_flax_variables` loads the JAX models' flat variables into them
and :meth:`init_weights` draws flax's default initialisers (not its
stream).  LayerNorm takes flax's epsilon, 1e-6.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ml_audio_inpainting_torch.models.cnn_blstm import _lecun_normal_
from ml_audio_inpainting_torch.ops.lstm import BiLSTM

__all__ = ["StackedBLSTM", "StackedBLSTMGapOnly", "StackedNormBLSTM", "load_flax_variables"]

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm default


class _Legacy(nn.Module):
    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's defaults: ``lecun_normal`` dense kernels with zero biases,
        LayerNorm scale 1 and bias 0, the BiLSTMs' U[0, 2/sqrt(H)); drawn on
        the CPU from ``generator``, in module order."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                _lecun_normal_(module.weight, module.in_features, generator)
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.reset_parameters()
            elif isinstance(module, BiLSTM):
                module.init_weights(generator)

    def _dropout(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(x) if self.dropout is not None else x


class StackedBLSTM(_Legacy):
    def __init__(self, audio_feat_dim: int = 257, hidden_dim: int = 128, num_layers: int = 3,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.blstm = BiLSTM(audio_feat_dim, hidden_dim, num_layers)
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0 else None
        self.fc = nn.Linear(2 * hidden_dim, audio_feat_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self._dropout(self.blstm(x)))

    def reconstruct_spectrogram(self, log_spec_gap_tf: torch.Tensor,
                                gap_mask_tf: torch.Tensor) -> torch.Tensor:
        """The prediction inside the gap (mask 1), the input elsewhere, in
        eval mode; time-major."""
        was_training = self.training
        self.eval()
        try:
            pred = self(log_spec_gap_tf)
        finally:
            self.train(was_training)
        return pred * gap_mask_tf + log_spec_gap_tf * (1.0 - gap_mask_tf)


class StackedBLSTMGapOnly(_Legacy):
    """Predicts only the gap columns: ``(B, T, gap_feat_dim)`` with
    ``gap_feat_dim = ceil(audio_feat_dim * gap_fraction)``
    (``models_OLD.py:92``)."""

    def __init__(self, audio_feat_dim: int = 417, gap_fraction: float = 0.2 / 5.0,
                 hidden_dim: int = 128, num_layers: int = 3, dropout_rate: float = 0.0):
        super().__init__()
        self.gap_feat_dim = math.ceil(audio_feat_dim * gap_fraction)
        self.blstm = BiLSTM(audio_feat_dim, hidden_dim, num_layers)
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0 else None
        self.fc1 = nn.Linear(2 * hidden_dim, 512)
        self.fc2 = nn.Linear(512, 128)
        self.fc3 = nn.Linear(128, self.gap_feat_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._dropout(self.blstm(x))
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.fc3(x)


class StackedNormBLSTM(_Legacy):
    """A one-layer BiLSTM and a LayerNorm, ``num_layers`` times, then the
    linear head."""

    def __init__(self, audio_feat_dim: int = 257, hidden_dim: int = 128, num_layers: int = 3,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"blstm{i}", BiLSTM(audio_feat_dim if i == 0 else 2 * hidden_dim,
                                                hidden_dim, 1))
            self.add_module(f"norm{i}", nn.LayerNorm(2 * hidden_dim, eps=LAYER_NORM_EPS))
        self.dropout = nn.Dropout(dropout_rate) if dropout_rate > 0 else None
        self.fc = nn.Linear(2 * hidden_dim, audio_feat_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"norm{i}")(getattr(self, f"blstm{i}")(x))
        return self.fc(self._dropout(x))


def load_flax_variables(model: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Load the JAX legacy model's flat ``params/...`` variables into
    ``model`` strictly: BiLSTM parameters by name, dense kernels ``(in,
    out)`` transposed into ``nn.Linear`` weights, LayerNorm ``scale`` into
    ``weight``."""
    sd = {}
    for key, value in flat.items():
        collection, module, leaf = key.split("/")
        if collection != "params":
            raise ValueError(f"unexpected legacy BLSTM weight key {key!r}")
        arr = np.asarray(value, np.float32)
        if module.startswith("blstm"):
            sd[f"{module}.{leaf}"] = arr
        elif leaf == "kernel":
            sd[f"{module}.weight"] = arr.T
        elif leaf == "scale":
            sd[f"{module}.weight"] = arr
        else:
            sd[f"{module}.{leaf}"] = arr
    model.load_state_dict({k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()})
    return model

"""Model construction from a config (port of
``ml_audio_inpainting_tpu/train/cnn_trainer.py::build_model``)."""

from __future__ import annotations

from ml_audio_inpainting_torch.models.cnn_blstm import StackedBLSTMCNN
from ml_audio_inpainting_torch.utils.config import Config

__all__ = ["build_model"]


def build_model(cfg: Config, device="cuda") -> StackedBLSTMCNN:
    """The CNN+BiLSTM of ``cfg`` on ``device``, weights not yet loaded."""
    m = cfg.model.cnn_blstm
    return StackedBLSTMCNN(
        in_channels=m.in_channels,
        num_lstm_layers=m.num_lstm_layers,
        lstm_hidden_dim=m.lstm_hidden_dim,
        freq_bins=cfg.data.spectrogram.freq_bins,
        enc_filters=tuple(m.enc_filters),
        dec_filters=tuple(m.dec_filters),
    ).to(device)

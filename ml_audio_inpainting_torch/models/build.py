"""Model construction from a config (port of
``ml_audio_inpainting_tpu/train/cnn_trainer.py::build_model`` and
``train/gan_trainer.py::build_generator``)."""

from __future__ import annotations

from ml_audio_inpainting_torch.models.cnn_blstm import StackedBLSTMCNN
from ml_audio_inpainting_torch.models.pconv_unet import PConvUNet
from ml_audio_inpainting_torch.utils.config import Config

__all__ = ["build_model", "build_generator"]


def build_model(cfg: Config, device="cuda") -> StackedBLSTMCNN:
    """The CNN+BiLSTM of ``cfg`` on ``device`` in eval mode (serving's; the
    trainer switches it to train mode), weights not yet loaded."""
    m = cfg.model.cnn_blstm
    return StackedBLSTMCNN(
        in_channels=m.in_channels,
        num_lstm_layers=m.num_lstm_layers,
        lstm_hidden_dim=m.lstm_hidden_dim,
        freq_bins=cfg.data.spectrogram.freq_bins,
        enc_filters=tuple(m.enc_filters),
        dec_filters=tuple(m.dec_filters),
    ).to(device).eval()


def build_generator(cfg: Config, device="cuda") -> PConvUNet:
    """The PConv U-Net generator of ``cfg`` on ``device`` in eval mode,
    weights not yet loaded."""
    g = cfg.model.generator
    return PConvUNet(
        enc_layer_cfg=tuple(tuple(layer) for layer in g.enc_layer_cfg),
        dec_layer_cfg=tuple(tuple(layer) for layer in g.dec_layer_cfg),
        final_interim_ch=g.final_interim_ch,
        final_kernel=g.final_kernel,
        output_channels=g.output_channels,
    ).to(device).eval()

"""The CNN+BiLSTM training loss (port of
``ml_audio_inpainting_tpu/train/losses.py::cnn_gap_l1_loss``)."""

from __future__ import annotations

import torch

__all__ = ["cnn_gap_l1_loss"]


def cnn_gap_l1_loss(
    log_pred: torch.Tensor, target_mag: torch.Tensor, gap_mask: torch.Tensor
) -> torch.Tensor:
    """Sum-reduced L1 between ``10 ** log_pred`` and the linear target
    magnitude, inside the gap only (mask 1 = gap)."""
    pred_lin = torch.pow(10.0, log_pred)
    return torch.sum(torch.abs(pred_lin * gap_mask - target_mag * gap_mask))

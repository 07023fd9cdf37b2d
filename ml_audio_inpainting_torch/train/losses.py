"""Training losses of both families (port of
``ml_audio_inpainting_tpu/train/losses.py``): the CNN+BiLSTM's gap L1 and
its phase-mode complex L1, and
the GAN's six-term generator objective and BCE discriminator loss
(``losses.py:66-119``)."""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ml_audio_inpainting_torch.parallel.collectives import global_mean, global_sum

__all__ = ["bce_with_logits", "cnn_gap_l1_loss", "cnn_phase_l1_loss", "generator_losses",
           "discriminator_loss"]


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, in JAX's form:
    ``mean(max(z, 0) - z * t + log1p(exp(-|z|)))``."""
    return global_mean(
        torch.clamp_min(logits, 0) - logits * targets + torch.log1p(torch.exp(-logits.abs())))


def cnn_gap_l1_loss(
    log_pred: torch.Tensor, target_mag: torch.Tensor, gap_mask: torch.Tensor
) -> torch.Tensor:
    """Sum-reduced L1 between ``10 ** log_pred`` and the linear target
    magnitude, inside the gap only (mask 1 = gap)."""
    pred_lin = torch.pow(10.0, log_pred)
    return global_sum(torch.sum(torch.abs(pred_lin * gap_mask - target_mag * gap_mask)))


def cnn_phase_l1_loss(
    pred_channels: torch.Tensor, target_complex: torch.Tensor, gap_mask: torch.Tensor
) -> torch.Tensor:
    """Complex L1 of the phase-mode model (``losses.py:48-59``): the summed
    modulus of ``(pred - target) * gap_mask``, ``pred_channels`` ``(B, F, T,
    2)`` real and imaginary parts.  The modulus is the complex ``abs``,
    whose gradient at an exact zero (every bin outside the gap) is 0, as
    JAX's is, not the NaN of ``sqrt(re^2 + im^2)``."""
    pred_c = torch.complex(pred_channels[..., 0], pred_channels[..., 1])
    err = (pred_c - target_complex) * gap_mask
    return global_sum(torch.sum(torch.abs(err)))


def generator_losses(
    generated_mag: torch.Tensor,
    original_mag: torch.Tensor,
    mask: torch.Tensor,
    d_fake_logits: torch.Tensor,
    lambdas: Mapping[str, float],
    vgg_losses: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The six-term generator objective and its terms (``g_total``,
    ``g_adv``, ``g_l1_valid``, ``g_l1_hole``, ``g_mag_weighted``,
    ``g_vgg_perceptual``, ``g_vgg_style``).  ``mask``: 1 = valid, 0 = hole;
    the L1 terms are sums over the valid or hole pixels divided by their
    count plus 1e-8; the VGG terms are 0 without ``vgg_losses``."""
    g_adv = bce_with_logits(d_fake_logits, torch.ones_like(d_fake_logits))
    valid_cnt = global_sum(mask.sum()) + 1e-8
    g_l1_valid = global_sum((generated_mag * mask - original_mag * mask).abs().sum()) / valid_cnt
    hole = 1.0 - mask
    hole_cnt = global_sum(hole.sum()) + 1e-8
    g_l1_hole = global_sum((generated_mag * hole - original_mag * hole).abs().sum()) / hole_cnt
    g_mag_weighted = global_mean((generated_mag - original_mag).abs() * original_mag.abs())
    if vgg_losses is None:
        zero = torch.zeros((), dtype=generated_mag.dtype, device=generated_mag.device)
        vgg_losses = (zero, zero)
    g_vgg_p, g_vgg_s = vgg_losses
    g_total = (
        lambdas["lambda_adv"] * g_adv
        + lambdas["lambda_l1_valid"] * g_l1_valid
        + lambdas["lambda_l1_hole"] * g_l1_hole
        + lambdas["lambda_mag_weighted"] * g_mag_weighted
        + lambdas["lambda_vgg_perceptual"] * g_vgg_p
        + lambdas["lambda_vgg_style"] * g_vgg_s
    )
    return {
        "g_total": g_total,
        "g_adv": g_adv,
        "g_l1_valid": g_l1_valid,
        "g_l1_hole": g_l1_hole,
        "g_mag_weighted": g_mag_weighted,
        "g_vgg_perceptual": g_vgg_p,
        "g_vgg_style": g_vgg_s,
    }


def discriminator_loss(
    d_real_logits: torch.Tensor, d_fake_logits: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """PatchGAN BCE: ``d_total`` is the mean of real-vs-1 (``d_real``) and
    fake-vs-0 (``d_fake``)."""
    d_real = bce_with_logits(d_real_logits, torch.ones_like(d_real_logits))
    d_fake = bce_with_logits(d_fake_logits, torch.zeros_like(d_fake_logits))
    return {"d_total": 0.5 * (d_real + d_fake), "d_real": d_real, "d_fake": d_fake}

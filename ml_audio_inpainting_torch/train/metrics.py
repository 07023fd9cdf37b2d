"""Quality metrics (port of ``ml_audio_inpainting_tpu/train/metrics.py``):
SNR, SDR over the gap, log-spectral distance, spectral convergence and the
frequency-weighted segmental SNR.

Each takes ``(..., T)`` waveforms (or ``(..., F, N)`` magnitudes for
:func:`spectral_convergence`) on any device and returns one value per
leading index, on that device.  The spectral metrics use the port's
:func:`~ml_audio_inpainting_torch.ops.stft.stft` (512/128, Hann).  The
auditory-model PSM score is in ``train/auditory.py``, the PEAQ-class ODG in
``train/peaq.py``.
"""

from __future__ import annotations

import torch

from ml_audio_inpainting_torch.ops.stft import stft

__all__ = ["snr", "gap_sdr", "log_spectral_distance", "spectral_convergence", "fwseg_snr"]


def snr(reference: torch.Tensor, estimate: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``10 log10(||ref||^2 / ||ref - est||^2)`` (MATLAB ``snr(x, x - y)``)."""
    num = torch.sum(reference**2, dim=-1)
    den = torch.sum((reference - estimate) ** 2, dim=-1) + eps
    return 10.0 * torch.log10(num / den + eps)


def gap_sdr(reference: torch.Tensor, estimate: torch.Tensor, gap_mask: torch.Tensor,
            eps: float = 1e-12) -> torch.Tensor:
    """SNR over the gap's samples only; ``gap_mask``: 1 = gap."""
    num = torch.sum((reference * gap_mask) ** 2, dim=-1)
    den = torch.sum(((reference - estimate) * gap_mask) ** 2, dim=-1) + eps
    return 10.0 * torch.log10(num / den + eps)


def log_spectral_distance(reference: torch.Tensor, estimate: torch.Tensor, n_fft: int = 512,
                          hop_length: int = 128, eps: float = 1e-8) -> torch.Tensor:
    """RMS distance between the log-power spectra, in dB."""
    pr = stft(reference, n_fft=n_fft, hop_length=hop_length).abs() ** 2
    pe = stft(estimate, n_fft=n_fft, hop_length=hop_length).abs() ** 2
    d = 10.0 * (torch.log10(pr + eps) - torch.log10(pe + eps))
    return torch.sqrt(torch.mean(d**2, dim=(-2, -1)))


def spectral_convergence(reference_mag: torch.Tensor, estimate_mag: torch.Tensor,
                         eps: float = 1e-12) -> torch.Tensor:
    """``||R - E||_F / ||R||_F`` over magnitude spectrograms."""
    num = torch.sqrt(torch.sum((reference_mag - estimate_mag) ** 2, dim=(-2, -1)))
    den = torch.sqrt(torch.sum(reference_mag**2, dim=(-2, -1))) + eps
    return num / den


def fwseg_snr(reference: torch.Tensor, estimate: torch.Tensor, n_fft: int = 512,
              hop_length: int = 128, gamma: float = 0.2, eps: float = 1e-10) -> torch.Tensor:
    """Frequency-weighted segmental SNR in dB: each bin's SNR, clamped to
    [-10, 35] dB, weighted by the reference magnitude to the power
    ``gamma``, averaged over bins and frames."""
    mr = stft(reference, n_fft=n_fft, hop_length=hop_length).abs()
    me = stft(estimate, n_fft=n_fft, hop_length=hop_length).abs()
    w = mr**gamma
    snr_bins = 10.0 * torch.log10((mr**2 + eps) / ((mr - me) ** 2 + eps))
    snr_bins = torch.clamp(snr_bins, -10.0, 35.0)
    return torch.sum(w * snr_bins, dim=(-2, -1)) / (torch.sum(w, dim=(-2, -1)) + eps)

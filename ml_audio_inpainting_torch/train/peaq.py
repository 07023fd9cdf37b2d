"""PEAQ-class objective difference grade (ODG) (port of
``ml_audio_inpainting_tpu/train/peaq.py``).

1. The FFT ear model of ITU-R BS.1387's basic version: Hann-windowed
   2048-sample frames at 50 % overlap, playback-level scaling, the
   outer/middle-ear weighting, grouping into 0.25-Bark bands (``z =
   7 asinh(f / 650)``), level-dependent spreading (27 dB/Bark below, ``-24 -
   230 / f + 0.2 L`` dB/Bark above, 0.4-power superposition), internal noise
   and forward time smearing: the excitation patterns.
2. The masking threshold: the excitation less the masking offset (3 dB up
   to 12 Bark, ``0.25 z`` dB above).
3. The total noise-to-mask ratio: the unspread band patterns of the
   spectral difference against the threshold, averaged over bands and
   frames (the basic version's ``Total NMR_B``).
4. ``ODG = -4 sigmoid(g(NMR))``, ``g`` piecewise linear through three
   anchors (:data:`ODG_MAPPING` names the calibration; the anchors are the
   JAX module's, see ``_ODG_ANCHORS``).

The constants (grouping matrix, weightings, band grid) are host numpy,
built once a sample rate; the band grouping's matrix products run in full
f32 on the card (TF32 would move the NMR by far more than the metric's
resolution).  Every function takes ``(..., T)`` waveforms of at least 2048
samples on any device and is batched over the leading axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ml_audio_inpainting_torch.utils.precision import full_f32_matmuls

__all__ = ["excitation_patterns", "nmr_total", "odg_score", "ODG_MAPPING"]

# The calibration's tag, stamped into every record of ODG values: two
# records compare only if their tags match.
ODG_MAPPING = "piecewise-logit-3anchor-2026-08-17"

_LISTENING_LEVEL_DB = 92.0  # dB SPL of a full-scale sine
_FRAME = 2048
_HOP = 1024
_BARK_RES = 0.25
_F_LO = 80.0

# (total NMR dB, ODG) anchors: the reference's recorded grades of the CNN
# (-3.80) and GAN (-3.91) reconstructions of its anchor clip, and the AR
# grade (-1.73) tied to -25.86 dB NMR; g is linear in logit space between
# them, its end slopes carried on beyond.
_ODG_ANCHORS = ((-25.86, -1.73), (2.646, -3.80), (14.116, -3.91))
_ODG_X = np.array([a[0] for a in _ODG_ANCHORS])
_ODG_A = np.array([np.log(q / (1.0 - q)) for q in [-o / 4.0 for _, o in _ODG_ANCHORS]])
_ODG_S1 = float((_ODG_A[1] - _ODG_A[0]) / (_ODG_X[1] - _ODG_X[0]))
_ODG_S2 = float((_ODG_A[2] - _ODG_A[1]) / (_ODG_X[2] - _ODG_X[1]))


def _bark(f):
    """BS.1387's Bark approximation (Schroeder): ``z = 7 asinh(f / 650)``."""
    return 7.0 * np.arcsinh(np.asarray(f) / 650.0)


def _outer_middle_ear_db(f_hz: np.ndarray) -> np.ndarray:
    """The outer/middle-ear weighting W(f) in dB (BS.1387's FFT model)."""
    f = np.maximum(f_hz, 1e-3) / 1000.0
    return -0.6 * 3.64 * f**-0.8 + 6.5 * np.exp(-0.6 * (f - 3.3) ** 2) - 1e-3 * f**3.6


@functools.lru_cache(maxsize=8)
def _ear_constants(sample_rate: int):
    """``(G, W, level_scale, fc, z_c, e_internal, alpha, mask_div)``, host
    numpy f32: the band grouping matrix ``(n_bands, n_bins)``, the ear's
    power weighting a bin, the level scale, the bands' centres in Hz and
    Bark, the internal noise, the smearing coefficients and the masking
    offsets a band."""
    freqs = np.fft.rfftfreq(_FRAME, 1.0 / sample_rate)

    # 0.25-Bark bands from 80 Hz to Nyquist.
    z_lo = _bark(_F_LO)
    z_hi = _bark(sample_rate / 2.0)
    n_bands = int(np.floor((z_hi - z_lo) / _BARK_RES))
    z_edges = z_lo + _BARK_RES * np.arange(n_bands + 1)
    z_c = 0.5 * (z_edges[:-1] + z_edges[1:])
    fc = 650.0 * np.sinh(z_c / 7.0)

    # Each bin's energy goes to the bands its width overlaps, in proportion.
    bin_z_lo = _bark(np.maximum(freqs - 0.5 * sample_rate / _FRAME, 0.0))
    bin_z_hi = _bark(freqs + 0.5 * sample_rate / _FRAME)
    bin_w = np.maximum(bin_z_hi - bin_z_lo, 1e-12)
    lo = np.maximum(z_edges[:-1, None], bin_z_lo[None, :])
    hi = np.minimum(z_edges[1:, None], bin_z_hi[None, :])
    G = np.maximum(hi - lo, 0.0) / bin_w[None, :]

    W = 10.0 ** (_outer_middle_ear_db(freqs) / 10.0)

    # A full-scale sine through the sqrt(8/3)-scaled Hann window has a DFT
    # peak power of (8/3) (N/4)^2; it is played at 92 dB SPL.
    peak = (8.0 / 3.0) * (_FRAME / 4.0) ** 2
    level_scale = 10.0 ** (_LISTENING_LEVEL_DB / 10.0) / peak

    e_internal = 10.0 ** (0.4 * 0.364 * (fc / 1000.0) ** -0.8)

    # Time smearing: tau = 8 ms + (100 Hz / fc) 22 ms.
    tau = 0.008 + (100.0 / fc) * (0.030 - 0.008)
    alpha = np.exp(-_HOP / (sample_rate * tau))

    m_db = np.where(z_c <= 12.0, 3.0, 0.25 * z_c)
    mask_div = 10.0 ** (m_db / 10.0)

    return (
        G.astype(np.float32),
        W.astype(np.float32),
        np.float32(level_scale),
        fc.astype(np.float32),
        z_c.astype(np.float32),
        e_internal.astype(np.float32),
        alpha.astype(np.float32),
        mask_div.astype(np.float32),
    )


@functools.lru_cache(maxsize=8)
def _device_constants(sample_rate: int, device: torch.device) -> dict:
    """The tensors of :func:`_ear_constants` and the analysis window on
    ``device``, copied there once."""
    G, W, _, fc, z_c, e_internal, alpha, mask_div = _ear_constants(sample_rate)
    win = np.sqrt(8.0 / 3.0) * np.hanning(_FRAME).astype(np.float32)
    host = dict(G_T=np.ascontiguousarray(G.T), W=W, fc=fc, dz=z_c[:, None] - z_c[None, :],
                e_internal=e_internal, alpha=alpha, mask_div=mask_div,
                window=win.astype(np.float32))
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def _frame_power_spectra(x: torch.Tensor, consts: dict) -> torch.Tensor:
    """``(..., T)`` -> the frames' power spectra ``(..., n_frames, n_bins)``."""
    T = x.shape[-1]
    if T < _FRAME:
        raise ValueError(f"input too short for the PEAQ ear model: {T} < {_FRAME} samples")
    frames = x.unfold(-1, _FRAME, _HOP)
    return torch.fft.rfft(frames * consts["window"]).abs() ** 2


def _group(bins: torch.Tensor, consts: dict) -> torch.Tensor:
    """Bins ``(..., n_frames, n_bins)`` -> bands ``(..., n_frames,
    n_bands)``, in full f32."""
    with full_f32_matmuls():
        return bins @ consts["G_T"]


def _spread(bands: torch.Tensor, consts: dict) -> torch.Tensor:
    """Level-dependent frequency spreading with 0.4-power superposition,
    ``(..., n_frames, n_bands)`` -> the same shape."""
    dz = consts["dz"]  # (target j, source k)
    L = 10.0 * torch.log10(torch.clamp_min(bands, 1e-12))
    s_upper = -24.0 - 230.0 / consts["fc"][None, :] + 0.2 * L
    lower_db = torch.where(dz < 0.0, dz * 27.0, 0.0)
    upper_gain = torch.clamp_min(dz, 0.0)
    w_db = lower_db + upper_gain * s_upper[..., None, :]  # (..., F, J, K)
    w = torch.pow(10.0, w_db / 10.0)
    w = w / torch.sum(w, dim=-2, keepdim=True)  # each source band's spread sums to 1
    return torch.sum((w * bands[..., None, :]) ** 0.4, dim=-1) ** 2.5


def _excitation(power: torch.Tensor, consts: dict, level_scale: float) -> torch.Tensor:
    """Excitation patterns from the frames' power spectra."""
    e = _spread(_group(power * level_scale * consts["W"], consts), consts) + consts["e_internal"]
    # Forward smearing over frames: e_f[n] = a e_f[n-1] + (1 - a) e[n];
    # the pattern is max(e_f, e).
    alpha = consts["alpha"]
    ef = torch.zeros_like(e[..., 0, :])
    out = []
    for n in range(e.shape[-2]):
        en = e[..., n, :]
        ef = alpha * ef + (1.0 - alpha) * en
        out.append(torch.maximum(ef, en))
    return torch.stack(out, dim=-2)


def excitation_patterns(x: torch.Tensor, sample_rate: int = 16000) -> torch.Tensor:
    """Excitation patterns ``(..., n_frames, n_bands)`` of the FFT ear model
    (weighting, band grouping, spreading, internal noise, time
    smearing)."""
    consts = _device_constants(sample_rate, x.device)
    level_scale = float(_ear_constants(sample_rate)[2])
    return _excitation(_frame_power_spectra(x, consts), consts, level_scale)


def nmr_total(reference: torch.Tensor, test: torch.Tensor,
              sample_rate: int = 16000) -> torch.Tensor:
    """The total noise-to-mask ratio in dB (BS.1387's basic ``Total
    NMR_B``): the band energies of the spectral difference ``|sqrt(P_ref) -
    sqrt(P_test)|^2`` (ear-weighted, unspread) over the reference's
    excitation less the masking offset."""
    consts = _device_constants(sample_rate, reference.device)
    level_scale = float(_ear_constants(sample_rate)[2])
    pr = _frame_power_spectra(reference, consts)
    pt = _frame_power_spectra(test, consts)
    noise = (torch.sqrt(pr * level_scale) - torch.sqrt(pt * level_scale)) ** 2 * consts["W"]
    p_noise = _group(noise, consts)
    mask = _excitation(pr, consts, level_scale) / consts["mask_div"]
    nmr = torch.mean(p_noise / torch.clamp_min(mask, 1e-12), dim=(-1, -2))
    return 10.0 * torch.log10(torch.clamp_min(nmr, 1e-12))


def _odg_of_nmr(nmr: torch.Tensor) -> torch.Tensor:
    """``-4 sigmoid(g(nmr))``, ``g`` linear between the anchors."""
    a = torch.where(
        nmr < float(_ODG_X[1]),
        float(_ODG_A[0]) + _ODG_S1 * (nmr - float(_ODG_X[0])),
        float(_ODG_A[1]) + _ODG_S2 * (nmr - float(_ODG_X[1])),
    )
    return -4.0 * torch.sigmoid(a)


def odg_score(reference: torch.Tensor, test: torch.Tensor,
              sample_rate: int = 16000) -> torch.Tensor:
    """The objective difference grade in [-4, 0] (0 imperceptible, -4 very
    annoying), one value per leading index."""
    return _odg_of_nmr(nmr_total(reference, test, sample_rate))

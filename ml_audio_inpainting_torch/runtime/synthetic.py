"""Seeded synthetic serving requests: a batch of speech-like 5 s clips with
the CLI's default gap (80 ms at 2.0 s).  ``chip_smoke.py`` and the profile
scripts (``scripts/torch_cnn_serving_profile.py``,
``scripts/torch_gan_serving_profile.py``) serve these requests: the CNN+BiLSTM
one (:func:`speech_like_batch`) and the GAN one of ``bench.py``'s canonical
line (:func:`gan_config`, :func:`synthetic_dataset_batch`)."""

from __future__ import annotations

import numpy as np

from ml_audio_inpainting_torch.data.dataset import SyntheticSpeechDataset
from ml_audio_inpainting_torch.utils.config import Config, SpectrogramConfig

__all__ = [
    "BATCH",
    "GAP_LEN",
    "GAP_START",
    "SAMPLE_RATE",
    "speech_like_batch",
    "gan_config",
    "synthetic_dataset_batch",
]

SAMPLE_RATE = 16000
BATCH = 32
GAP_START, GAP_LEN = 32000, 1280  # 80 ms at 2.0 s, the CLI defaults


def speech_like_batch(rng: np.random.Generator, batch: int, seconds: float = 5.0) -> np.ndarray:
    """``tests/conftest.py::speech_like`` (an AM-modulated harmonic stack over
    a noise floor, peak 1), one clip a row with its own seeded f0 contour,
    envelope rate and noise: ``(batch, SAMPLE_RATE * seconds)`` f32."""
    t = np.arange(int(SAMPLE_RATE * seconds)) / SAMPLE_RATE
    clips = []
    for _ in range(batch):
        f0 = rng.uniform(90, 180) + 30 * np.sin(2 * np.pi * rng.uniform(0.4, 1.0) * t)
        phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
        sig = sum((0.5 / k) * np.sin(k * phase) for k in range(1, 6))
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(1.5, 3.0) * t))
        sig = env * sig + 0.01 * rng.standard_normal(len(t))
        clips.append(sig / np.max(np.abs(sig)))
    return np.stack(clips).astype(np.float32)


def gan_config() -> Config:
    """``bench.py``'s GAN configuration: STFT 512/128/512, 5 s clips, the
    default generator widths."""
    cfg = Config()
    cfg.data.spectrogram = SpectrogramConfig(n_fft=512, hop_length=128, win_length=512)
    cfg.data.max_len_s = 5.0
    return cfg


def synthetic_dataset_batch(batch: int, seconds: float = 5.0) -> np.ndarray:
    """Items ``0..batch-1`` of ``SyntheticSpeechDataset(max_len_s=seconds)``,
    ``(batch, SAMPLE_RATE * seconds)`` f32: the clips ``bench.py`` serves."""
    ds = SyntheticSpeechDataset(n_items=batch, sample_rate=SAMPLE_RATE, max_len_s=seconds)
    return np.stack([ds[i] for i in range(batch)])

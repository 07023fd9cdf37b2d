"""Seeded synthetic serving requests: a batch of speech-like 5 s clips with
the CLI's default gap (80 ms at 2.0 s).  ``chip_smoke.py`` and
``scripts/torch_cnn_serving_profile.py`` both serve this request."""

from __future__ import annotations

import numpy as np

__all__ = ["BATCH", "GAP_LEN", "GAP_START", "SAMPLE_RATE", "speech_like_batch"]

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

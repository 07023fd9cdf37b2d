"""Deterministic synthetic speech corpus (port of
``ml_audio_inpainting_tpu/data/dataset.py::SyntheticSpeechDataset``): the
clips ``bench.py`` serves for its canonical line, bit for bit the JAX
package's (numpy only, one blake2s-seeded generator an item).  The file
corpora of that module wait for the port's file-I/O slice."""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["SyntheticSpeechDataset"]


class SyntheticSpeechDataset:
    """Item ``idx`` is an AM-modulated stack of 6 harmonics over a noise
    floor, peak 1, ``int(sample_rate * max_len_s)`` f32 samples, drawn from
    a generator seeded by ``blake2s(f"{seed}:{idx}")``."""

    def __init__(
        self,
        n_items: int = 128,
        sample_rate: int = 16000,
        max_len_s: float = 5.0,
        seed: int = 0,
    ):
        self.n_items = n_items
        self.sample_rate = sample_rate
        self.max_samples = int(sample_rate * max_len_s)
        self.seed = seed

    def __len__(self) -> int:
        return self.n_items

    def __getitem__(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(
            int.from_bytes(
                hashlib.blake2s(f"{self.seed}:{idx}".encode(), digest_size=8).digest(),
                "little",
            )
        )
        t = np.arange(self.max_samples) / self.sample_rate
        f0 = rng.uniform(90, 250) + rng.uniform(10, 50) * np.sin(
            2 * np.pi * rng.uniform(0.3, 1.5) * t
        )
        phase = 2 * np.pi * np.cumsum(f0) / self.sample_rate
        sig = sum(
            (rng.uniform(0.2, 0.6) / k) * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
            for k in range(1, 7)
        )
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(1.0, 4.0) * t + rng.uniform(0, 2 * np.pi)))
        sig = env * sig + 0.01 * rng.standard_normal(self.max_samples)
        return (sig / np.max(np.abs(sig))).astype(np.float32)

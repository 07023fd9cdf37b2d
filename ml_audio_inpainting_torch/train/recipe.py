"""The CNN+BiLSTM training recipes as the port's card runs them
(``chip_smoke.py``, ``scripts/torch_cnn_training_profile.py``): the values
of ``configs/cnn_blstm.yaml`` and of the production recipe
(``configs/cnn_blstm_b128.yaml`` trained with ``--train-n-gaps 3``) built in
Python (the card's machine has no YAML package), seeded gap positions, and
weights with a live BiLSTM."""

from __future__ import annotations

import math

import numpy as np
import torch

from ml_audio_inpainting_torch.data.multigap import random_multi_gap_layout
from ml_audio_inpainting_torch.ops.gaps import random_gap_mask
from ml_audio_inpainting_torch.utils.config import Config

__all__ = ["recipe_config", "b128_recipe_config", "gap_starts", "multi_gap_layouts",
           "live_bilstm"]


def recipe_config() -> Config:
    """``configs/cnn_blstm.yaml``'s data, model and training values: 5 s clips
    at 16 kHz, 1 clip x 25 gap variants of 0.2 s, STFT 512/192/384, enc
    16-32-64, BiLSTM 3 x 2 x 128, Adam at lr 1e-4."""
    return Config.from_dict({
        "data": {"sample_rate": 16000, "max_len_s": 5.0, "gap_len_s": 0.2,
                 "gaps_per_audio": 25,
                 "spectrogram": {"n_fft": 512, "hop_length": 192, "win_length": 384}},
        "model": {"in_channels": 1, "num_lstm_layers": 3, "lstm_hidden_dim": 128,
                  "enc_filters": [16, 32], "dec_filters": [16, 32]},
        "training": {"batch_size": 1, "optimizer_type": "adam",
                     "starter_learning_rate": 1e-4, "lr_decay": 1.0, "max_n_epochs": 50},
    })


def b128_recipe_config() -> Config:
    """The JAX package's production CNN recipe: ``configs/cnn_blstm_b128.yaml``'s
    data, model and training values (5 s clips at 16 kHz, 128 clips x 1 gap
    variant, STFT 512/192/384, enc 16-32-64, BiLSTM 3 x 2 x 128, Adam at lr
    3e-4) with ``train_n_gaps=3``: three gaps of up to 0.2 s a clip
    (``results/cnn_b128_bf16_r4_eval.json``: ``--batch-size 128
    --train-dtype bf16 --feed device --train-n-gaps 3``).  The dtype is the
    train step's argument, not the config's."""
    return Config.from_dict({
        "data": {"sample_rate": 16000, "max_len_s": 5.0, "gap_len_s": 0.2,
                 "gaps_per_audio": 1, "train_n_gaps": 3,
                 "spectrogram": {"n_fft": 512, "hop_length": 192, "win_length": 384}},
        "model": {"in_channels": 1, "num_lstm_layers": 3, "lstm_hidden_dim": 128,
                  "enc_filters": [16, 32], "dec_filters": [16, 32]},
        "training": {"batch_size": 128, "optimizer_type": "adam",
                     "starter_learning_rate": 3e-4, "lr_decay": 1.0, "max_n_epochs": 200},
    })


def gap_starts(gen: torch.Generator, cfg: Config, clips: int, variants: int) -> torch.Tensor:
    """``(clips, variants)`` int64 gap starts in samples, drawn as the
    trainer's random gaps are (``ops/gaps.py::random_gap_mask``)."""
    starts = [[random_gap_mask(gen, cfg.data.max_samples, cfg.data.gap_len_s,
                               cfg.data.sample_rate)[1][0].item() for _ in range(variants)]
              for _ in range(clips)]
    return torch.tensor(starts, dtype=torch.int64)


def multi_gap_layouts(gen: torch.Generator, cfg: Config, clips: int, variants: int) -> tuple:
    """``(starts, lengths)``, int64 ``(clips, variants, cfg.data.train_n_gaps)``:
    the gaps the JAX trainer's ``cnn_features`` lays out per variant
    (``multi_gap_mask`` of a clip of ``max_samples`` with gaps of up to
    ``gap_len_s``), from uniforms drawn from ``gen``."""
    starts, lengths = random_multi_gap_layout(
        gen, (clips, variants), cfg.data.max_samples, cfg.data.train_n_gaps,
        max_gap_ms=cfg.data.gap_len_s * 1000.0, sample_rate=cfg.data.sample_rate)
    return starts.to(torch.int64), lengths.to(torch.int64)


def live_bilstm(flat: dict, seed: int) -> dict:
    """``flat`` with every BiLSTM weight matrix redrawn from
    U(-1/sqrt(rows), 1/sqrt(rows)) (biases kept).  The committed checkpoint's
    BiLSTM is saturated: in both packages its gates' derivatives and so the
    gradients of the BiLSTM and of the encoder below it are exactly zero in
    f32.  From these weights every parameter gets a gradient, and
    ``lstm_bwd`` carries one."""
    rng = np.random.default_rng(seed)
    out = dict(flat)
    for key, value in flat.items():
        if key.startswith("params/lstm/") and not key.endswith("_b"):
            bound = 1.0 / math.sqrt(value.shape[0])
            out[key] = rng.uniform(-bound, bound, value.shape).astype(np.float32)
    return out

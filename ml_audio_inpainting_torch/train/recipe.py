"""The training recipes as the port's card runs them (``chip_smoke.py``,
``scripts/torch_cnn_training_profile.py``,
``scripts/torch_gan_training_profile.py``): the values of
``configs/cnn_blstm.yaml``, of the CNN production recipe
(``configs/cnn_blstm_b128.yaml`` trained with ``--train-n-gaps 3``) and of
the GAN's (``configs/gan.yaml`` at B=32 with 4 gaps a clip) built in Python
(the card's machine has no YAML package), seeded gap positions, and weights
with a live BiLSTM."""

from __future__ import annotations

import math

import numpy as np
import torch

from ml_audio_inpainting_torch.data.multigap import random_multi_gap_layout
from ml_audio_inpainting_torch.ops.gaps import random_gap_mask
from ml_audio_inpainting_torch.utils.config import Config

__all__ = ["recipe_config", "b128_recipe_config", "gan_recipe_config", "gap_starts",
           "multi_gap_layouts", "gan_gap_layouts", "live_bilstm"]


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


def gan_recipe_config() -> Config:
    """The JAX package's fastest GAN recipe: ``configs/gan.yaml``'s data,
    model and training values (5 s clips at 16 kHz, STFT 512/128/512, the
    default PConv U-Net and PatchGAN, Adam lr 2e-4 with betas (0.5, 0.999),
    lambdas adv 0.01, l1_valid 1, l1_hole 2, vgg_perceptual 4, vgg_style
    500, mag_weighted 0.2) at ``batch_size`` 32 with ``train_n_gaps=4``
    (``results/gan_b32_bf16_r4_eval.json``: B=32, 4 gaps a clip, bf16, EMA
    0.999, the device feed).  The dtype and the EMA are the train step's
    arguments, not the config's."""
    return Config.from_dict({
        "data": {"sample_rate": 16000, "max_len_s": 5.0, "gap_len_s": 0.2, "train_limit": 3000,
                 "train_n_gaps": 4,
                 "spectrogram": {"n_fft": 512, "hop_length": 128, "win_length": 512}},
        "model": {"generator": {"input_channels": 1, "mask_channels": 1, "output_channels": 1},
                  "discriminator": {"input_channels": 1}},
        "training": {"batch_size": 32, "epochs": 100, "g_lr": 2e-4, "d_lr": 2e-4, "b1": 0.5,
                     "b2": 0.999, "lambda_adv": 0.01, "lambda_l1_valid": 1.0,
                     "lambda_l1_hole": 2.0, "lambda_vgg_perceptual": 4.0,
                     "lambda_vgg_style": 500.0, "lambda_mag_weighted": 0.2},
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


def gan_gap_layouts(gen: torch.Generator, cfg: Config, clips: int) -> tuple:
    """The gap tensors ``make_gan_train_step`` takes for ``clips`` clips,
    drawn from ``gen`` as the JAX trainer's ``gan_features`` draws them:
    with ``cfg.data.train_n_gaps`` 1, ``(starts,)``, int64 ``(clips,)``
    (``random_gap_mask``); with K > 1, ``(starts, lengths)``, int64
    ``(clips, K)`` (``multi_gap_mask`` of gaps of up to ``gap_len_s``)."""
    if cfg.data.train_n_gaps == 1:
        return (gap_starts(gen, cfg, clips, 1)[:, 0],)
    starts, lengths = multi_gap_layouts(gen, cfg, clips, 1)
    return starts[:, 0], lengths[:, 0]


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

"""The multi-device dry run (port of ``__graft_entry__.dryrun_multichip``):
one train step of each family over ``n`` ranks, at the JAX entry's tiny
configurations (``__graft_entry__.py:17-45``).

* CNN+BiLSTM over a ``data x model`` mesh, 2-way model parallel where ``n``
  is even: at hidden 64, layer 0's ``w_ih`` (4128 x 256) is split over
  ``model``; the BiLSTM is redrawn live (``train/recipe.py::live_bilstm``:
  the initialiser's draw saturates it, and a saturated BiLSTM passes no
  gradient);
* the GAN over ``n``-way data parallelism, VGG off.

Each runs on the first rows of a seeded batch with seeded gaps drawn for
the global batch, and must give a finite loss.  ``python -m
ml_audio_inpainting_torch.parallel.dryrun 4 [--device cpu]``.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict

import numpy as np
import torch

from ml_audio_inpainting_torch.data.multigap import draw_gaps
from ml_audio_inpainting_torch.parallel.launch import spawn
from ml_audio_inpainting_torch.parallel.mesh import make_mesh, shard_batch
from ml_audio_inpainting_torch.parallel.sharding import make_sharded_step, place_state
from ml_audio_inpainting_torch.train.cnn_trainer import create_cnn_state, make_cnn_train_step
from ml_audio_inpainting_torch.train.gan_trainer import create_gan_states, make_gan_train_step
from ml_audio_inpainting_torch.train.recipe import live_bilstm
from ml_audio_inpainting_torch.utils.config import Config, SpectrogramConfig
from ml_audio_inpainting_torch.weights import cnn_blstm_flat_variables

__all__ = ["tiny_gan_config", "tiny_cnn_config", "dryrun_multichip"]

DRYRUN_SAMPLES = 8000


def tiny_gan_config() -> Config:
    cfg = Config()
    cfg.data.spectrogram = SpectrogramConfig(n_fft=256, hop_length=64, win_length=256)
    cfg.data.max_len_s = 0.5
    cfg.data.gap_len_s = 0.05
    cfg.model.generator.enc_layer_cfg = [(8, 7, 2), (16, 5, 2), (16, 3, 2)]
    cfg.model.generator.dec_layer_cfg = [(16, 3, 1), (8, 3, 1)]
    cfg.model.generator.final_interim_ch = 8
    cfg.model.discriminator.layer_cfg = [(8, 2), (16, 2)]
    cfg.training.lambda_vgg_perceptual = 0.0
    cfg.training.lambda_vgg_style = 0.0
    return cfg


def tiny_cnn_config() -> Config:
    cfg = Config()
    cfg.data.spectrogram = SpectrogramConfig(n_fft=256, hop_length=64, win_length=256)
    cfg.data.max_len_s = 0.5
    cfg.data.gap_len_s = 0.05
    cfg.data.gaps_per_audio = 2
    cfg.model.cnn_blstm.lstm_hidden_dim = 64
    cfg.model.cnn_blstm.num_lstm_layers = 1
    cfg.model.cnn_blstm.enc_filters = [4, 8]
    cfg.model.cnn_blstm.dec_filters = [4, 8]
    return cfg


def _gaps(gen: torch.Generator, cfg: Config, shape: tuple) -> tuple:
    d = cfg.data
    return draw_gaps(gen, shape, d.max_samples, d.gap_len_s, d.sample_rate, d.train_n_gaps)


def rank_program(device, n: int) -> Dict:
    """One rank of the dry run (every rank of a group of ``n``); returns its
    losses and what its mesh split."""
    model_parallel = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(n // model_parallel, model_parallel, device=device)
    dp_mesh = make_mesh(n, 1, device=device)
    audio = np.random.default_rng(0).standard_normal((n, DRYRUN_SAMPLES)).astype(np.float32)
    draws = torch.Generator().manual_seed(1)

    cfg = tiny_cnn_config()
    fresh = create_cnn_state(cfg, device="cpu", seed=0).model.state_dict()
    state = create_cnn_state(cfg, device=device,
                             params=live_bilstm(cnn_blstm_flat_variables(fresh), seed=2))
    step = make_sharded_step(make_cnn_train_step(cfg), state, mesh)
    place_state(state, mesh)
    rows = mesh.shape["data"]
    batch = (audio[:rows], *_gaps(draws, cfg, (rows, cfg.data.gaps_per_audio)))
    state, metrics = step(state, *shard_batch(batch, mesh))

    gcfg = tiny_gan_config()
    g_state, d_state = create_gan_states(gcfg, device=device)
    gan_step = make_sharded_step(make_gan_train_step(gcfg), (g_state, d_state), dp_mesh)
    batch = (audio, *_gaps(draws, gcfg, (n,)))
    g_state, d_state, gm = gan_step(g_state, d_state, *shard_batch(batch, dp_mesh))
    return {"cnn_loss": metrics["loss"].item(), "mesh": dict(mesh.shape),
            "sharded": sorted(state.shardings), "g_total": gm["g_total"].item(),
            "d_total": gm["d_total"].item()}


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Dict:
    """One train step of each family over ``n_devices`` ranks on ``device``'s
    kind; raises on a non-finite loss or ranks that disagree, and returns
    rank 0's losses and mesh."""
    return report([r.value for r in spawn(rank_program, n_devices, device, n_devices)],
                  device)


def report(results: list, device: str) -> Dict:
    """The dry run's check of its ranks' results (:func:`rank_program`'s),
    printed; rank 0's."""
    n_devices = len(results)
    out = results[0]
    for key in ("cnn_loss", "g_total", "d_total"):
        if not math.isfinite(out[key]):
            raise AssertionError(f"dryrun produced a non-finite {key}: {out[key]}")
        if any(r[key] != out[key] for r in results):
            raise AssertionError(f"ranks disagree on {key}: {[r[key] for r in results]}")
    print(f"dryrun_multichip OK on {n_devices} ranks ({device}): cnn loss={out['cnn_loss']:.3f} "
          f"(mesh {out['mesh']}, split {out['sharded']}), gan g_total={out['g_total']:.3f} "
          f"d_total={out['d_total']:.3f}", flush=True)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="one sharded train step of each family")
    parser.add_argument("n", type=int)
    parser.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    a = parser.parse_args()
    dryrun_multichip(a.n, a.device)

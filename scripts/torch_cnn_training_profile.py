#!/usr/bin/env python3
"""Where a CNN+BiLSTM training step of the PyTorch port spends its time on
one CUDA card (the training breakdown behind PERF.md section 5).

    python3 -m scripts.torch_cnn_training_profile    # from the repo root
    python3 -m scripts.torch_cnn_training_profile --recipe b128 --dtype bf16

By default takes the recipe of ``configs/cnn_blstm.yaml`` (``train/recipe.py``:
1 clip x 25 gap variants of 0.2 s, Adam at lr 1e-4, full width) from the
committed ``results/checkpoints/cnn_blstm_formant_v2_r2.npz``; ``--recipe
b128`` takes the production recipe (``b128_recipe_config``: 128 clips x 1
variant x 3 gaps of up to 0.2 s, Adam at lr 3e-4) from
``cnn_blstm_formant_v2_b128_r4.npz``; ``--dtype bf16`` runs the network in
bf16 over f32 masters (``compute_dtype=torch.bfloat16``).  Either way the
checkpoint's BiLSTM is redrawn (so every layer has a gradient), TF32 is off,
as ``chip_smoke.py`` does; warms up with two steps, then traces ``STEPS``
steps on seeded clips with ``torch.profiler``.  Prints one JSON object: the
host-clock time per step, the device kernels' time per step summed by layer
(the three LSTM kernels, convolutions and their gradients with cuDNN's
layout transposes, matrix products, FFTs, the optimizer, casts and copies,
reductions, other elementwise passes, the rest), the device's busy and idle
share of the traced wall time, and the top kernels by name.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from ml_audio_inpainting_torch.train.cnn_trainer import create_cnn_state, make_cnn_train_step
from ml_audio_inpainting_torch.train.recipe import (
    b128_recipe_config,
    gap_starts,
    live_bilstm,
    multi_gap_layouts,
    recipe_config,
)
from ml_audio_inpainting_torch.weights import load_params_npz
from scripts.torch_cnn_serving_profile import busy_us

REPO = Path(__file__).resolve().parents[1]
STEPS = 5
CHECKPOINTS = {"yaml": REPO / "results" / "checkpoints" / "cnn_blstm_formant_v2_r2.npz",
               "b128": REPO / "results" / "checkpoints" / "cnn_blstm_formant_v2_b128_r4.npz"}
DTYPES = {"f32": None, "bf16": torch.bfloat16}
# Layer of a device kernel, by its name (first match wins).
LAYERS = (
    ("lstm_fwd", re.compile(r"lstm_fwd")),
    ("lstm_bwd", re.compile(r"lstm_bwd_kernel")),
    ("lstm_dwhh", re.compile(r"lstm_dwhh")),
    # cuDNN's own FFT convolutions (fft2d_*, with cudnn:: arguments) are convolutions.
    ("convolution", re.compile(r"conv|fprop|dgrad|wgrad|implicit_gemm|winograd|cudnn", re.I)),
    # cuBLAS's Hopper kernels (bf16 products) are named nvjet_*.
    ("matmul", re.compile(r"gemm|sgemm|cutlass|xmma|cublas|matmul|nvjet", re.I)),
    ("fft", re.compile(r"fft", re.I)),
    ("optimizer", re.compile(r"adam|multi_tensor", re.I)),
    # The rest of PyTorch's own kernels: dtype casts and copies, reductions
    # (sums and means: BatchNorm's statistics, the loss), elementwise passes.
    ("copy_cast", re.compile(r"copy_kernel|bfloat16_copy", re.I)),
    ("reduction", re.compile(r"reduce_kernel", re.I)),
    ("elementwise", re.compile(r"elementwise_kernel", re.I)),
)


def layer_of(name: str) -> str:
    for layer, pattern in LAYERS:
        if pattern.search(name):
            return layer
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--recipe", choices=sorted(CHECKPOINTS), default="yaml",
                        help="yaml: configs/cnn_blstm.yaml (1 x 25); b128: the production recipe")
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script profiles the port on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    cfg = b128_recipe_config() if args.recipe == "b128" else recipe_config()
    clips, variants = cfg.training.batch_size, cfg.data.gaps_per_audio
    state = create_cnn_state(cfg, device="cuda",
                             params=live_bilstm(load_params_npz(CHECKPOINTS[args.recipe]), seed=6))
    step = make_cnn_train_step(cfg, compute_dtype=DTYPES[args.dtype])
    gen = torch.Generator().manual_seed(5)

    def gaps():
        if cfg.data.train_n_gaps > 1:
            return [t.cuda() for t in multi_gap_layouts(gen, cfg, clips, variants)]
        return [gap_starts(gen, cfg, clips, variants).cuda()]

    batches = [(torch.tensor(speech_like_batch(np.random.default_rng(100 + i), clips),
                             device="cuda"), gaps()) for i in range(2 + STEPS)]
    for audio, gap in batches[:2]:
        state, m = step(state, audio, *gap)
        m["loss"].item()
    torch.cuda.synchronize()

    step_ms = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_window = time.perf_counter()
        for audio, gap in batches[2:]:
            t0 = time.perf_counter()
            state, m = step(state, audio, *gap)
            m["loss"].item()  # synchronises
            step_ms.append(1e3 * (time.perf_counter() - t0))
        window_ms = 1e3 * (time.perf_counter() - t_window)

    by_layer, by_name, intervals = defaultdict(float), defaultdict(float), []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA or evt.is_user_annotation:  # a span's shadow
            continue
        start, end = evt.time_range.start, evt.time_range.end
        intervals.append((start, end))
        by_layer[layer_of(evt.name)] += (end - start) / 1e3
        by_name[evt.name] += (end - start) / 1e3
    kernel_ms = sum(by_layer.values())
    busy_ms = busy_us(intervals) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
    print(json.dumps({
        "card": smi,
        "recipe": args.recipe,
        "dtype": args.dtype,
        "clips": clips,
        "variants": variants,
        "steps": STEPS,
        "step_ms": step_ms,
        "window_ms": window_ms,
        "device_kernel_ms_per_step": {k: v / STEPS for k, v in sorted(by_layer.items())},
        "device_kernel_ms_per_step_total": kernel_ms / STEPS,
        "device_busy_share": busy_ms / window_ms,
        "device_idle_share": 1.0 - busy_ms / window_ms,
        "top_kernels_ms_per_step": [[name[:120], ms / STEPS] for name, ms in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

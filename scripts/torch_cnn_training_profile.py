#!/usr/bin/env python3
"""Where a CNN+BiLSTM training step of the PyTorch port spends its time on
one CUDA card (the training breakdown behind PERF.md section 5).

    python3 -m scripts.torch_cnn_training_profile    # from the repo root

Takes the recipe of ``configs/cnn_blstm.yaml`` (``train/recipe.py``: 1 clip
x 25 gap variants of 0.2 s, Adam at lr 1e-4, full width) from the committed
``results/checkpoints/cnn_blstm_formant_v2_r2.npz`` with its BiLSTM redrawn
(so every layer has a gradient), TF32 off, as ``chip_smoke.py`` does; warms
up with two steps, then traces ``STEPS`` steps on seeded clips with
``torch.profiler``.  Prints one JSON object: the host-clock time per step,
the device kernels' time per step summed by layer (the three LSTM kernels,
convolutions and their gradients, matrix products, FFTs, the optimizer, the
rest), the device's busy and idle share of the traced wall time, and the top
kernels by name.  Imports nothing of JAX.
"""

from __future__ import annotations

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
from ml_audio_inpainting_torch.train.recipe import gap_starts, live_bilstm, recipe_config
from ml_audio_inpainting_torch.weights import load_params_npz
from scripts.torch_cnn_serving_profile import busy_us

REPO = Path(__file__).resolve().parents[1]
STEPS = 5
CHECKPOINT = REPO / "results" / "checkpoints" / "cnn_blstm_formant_v2_r2.npz"
# Layer of a device kernel, by its name (first match wins).
LAYERS = (
    ("lstm_fwd", re.compile(r"lstm_fwd")),
    ("lstm_bwd", re.compile(r"lstm_bwd_kernel")),
    ("lstm_dwhh", re.compile(r"lstm_dwhh")),
    # cuDNN's own FFT convolutions (fft2d_*, with cudnn:: arguments) are convolutions.
    ("convolution", re.compile(r"conv|fprop|dgrad|wgrad|implicit_gemm|winograd|cudnn", re.I)),
    ("matmul", re.compile(r"gemm|sgemm|cutlass|xmma|cublas|matmul", re.I)),
    ("fft", re.compile(r"fft", re.I)),
    ("optimizer", re.compile(r"adam|multi_tensor", re.I)),
)


def layer_of(name: str) -> str:
    for layer, pattern in LAYERS:
        if pattern.search(name):
            return layer
    return "other"


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script profiles the port on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    cfg = recipe_config()
    variants = cfg.data.gaps_per_audio
    state = create_cnn_state(cfg, device="cuda",
                             params=live_bilstm(load_params_npz(CHECKPOINT), seed=6))
    step = make_cnn_train_step(cfg)
    gen = torch.Generator().manual_seed(5)
    batches = [(torch.tensor(speech_like_batch(np.random.default_rng(100 + i), 1), device="cuda"),
                gap_starts(gen, cfg, 1, variants).cuda()) for i in range(2 + STEPS)]
    for audio, starts in batches[:2]:
        state, m = step(state, audio, starts)
        m["loss"].item()
    torch.cuda.synchronize()

    step_ms = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_window = time.perf_counter()
        for audio, starts in batches[2:]:
            t0 = time.perf_counter()
            state, m = step(state, audio, starts)
            m["loss"].item()  # synchronises
            step_ms.append(1e3 * (time.perf_counter() - t0))
        window_ms = 1e3 * (time.perf_counter() - t_window)

    by_layer, by_name, intervals = defaultdict(float), defaultdict(float), []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
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
        "clips": 1,
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

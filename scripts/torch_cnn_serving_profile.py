#!/usr/bin/env python3
"""Where a CNN+BiLSTM serving request of the PyTorch port spends its time on
one CUDA card (the breakdown behind PERF.md section 5).

    python3 -m scripts.torch_cnn_serving_profile    # from the repo root

Builds the port's runner (``make_cnn_runner``, ``oracle``) from the committed
``results/checkpoints/cnn_blstm_formant_v2_r2.npz`` with TF32 off, as
``chip_smoke.py`` does, warms it up with two requests, then traces
``REQUESTS`` requests of the same batch as ``chip_smoke.py`` (``BATCH`` seeded
speech-like 5 s clips, 80 ms gap at 2.0 s, ``runtime/synthetic.py``) with
``torch.profiler``.  Prints one JSON object: the host-clock time per
request, the device kernels' time summed by layer (the LSTM kernel, the
matmuls, the convolutions, the FFTs, the rest), the device's busy and idle
share of the traced wall time, and the top kernels by name.  Imports nothing
of JAX.
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

from ml_audio_inpainting_torch.runtime.serve import make_cnn_runner
from ml_audio_inpainting_torch.runtime.synthetic import (
    BATCH,
    GAP_LEN,
    GAP_START,
    speech_like_batch,
)
from ml_audio_inpainting_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]
REQUESTS = 5
CHECKPOINT = REPO / "results" / "checkpoints" / "cnn_blstm_formant_v2_r2.npz"
# Layer of a device kernel, by its name (first match wins).
LAYERS = (
    ("lstm_kernel", re.compile(r"lstm_fwd")),
    ("convolution", re.compile(r"conv|fprop|dgrad|implicit_gemm|winograd", re.I)),
    ("matmul", re.compile(r"gemm|sgemm|cutlass|xmma|cublas|matmul", re.I)),
    ("fft", re.compile(r"fft", re.I)),
)


def layer_of(name: str) -> str:
    for layer, pattern in LAYERS:
        if pattern.search(name):
            return layer
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script profiles the port on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    runner = make_cnn_runner(Config(), CHECKPOINT, device="cuda", phase="oracle")
    audio = torch.tensor(speech_like_batch(np.random.default_rng(1), BATCH), device="cuda")
    starts = torch.full((BATCH,), GAP_START, device="cuda")
    lens = torch.full((BATCH,), GAP_LEN, device="cuda")
    for _ in range(2):
        runner(audio, starts, lens)
    torch.cuda.synchronize()

    request_ms = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_window = time.perf_counter()
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            runner(audio, starts, lens)
            torch.cuda.synchronize()
            request_ms.append(1e3 * (time.perf_counter() - t0))
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "card": smi,
        "batch": BATCH,
        "requests": REQUESTS,
        "request_ms": request_ms,
        "window_ms": window_ms,
        "device_kernel_ms_per_request": {k: v / REQUESTS for k, v in sorted(by_layer.items())},
        "device_kernel_ms_per_request_total": kernel_ms / REQUESTS,
        "device_busy_share": busy_ms / window_ms,
        "device_idle_share": 1.0 - busy_ms / window_ms,
        "top_kernels_ms_per_request": [[name[:120], ms / REQUESTS] for name, ms in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

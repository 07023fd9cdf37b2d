#!/usr/bin/env python3
"""Where a GAN serving request of the PyTorch port spends its time on one
CUDA card (the breakdown behind PERF.md section 5).

    python3 -m scripts.torch_gan_serving_profile    # from the repo root
    python3 -m scripts.torch_gan_serving_profile --phase griffinlim --dtype f32

Serves ``chip_smoke.py``'s ``gan_serving`` request, ``bench.py``'s canonical
line: the GAN runner (``make_gan_runner``, ``mode="enhanced"``, the phase
regime of ``--phase``, ``oracle`` by default, gap-only PCM16 transport) with
the committed
``results/checkpoints/gan_formant_v2_r2.npz``, on ``BATCH`` clips of 5 s from
``SyntheticSpeechDataset`` with an 80 ms gap at 2.0 s, in f32 (TF32 off) and
in bf16.  For each, it warms up with two requests, then traces ``REQUESTS``
requests with ``torch.profiler``, each ending in the payload's fetch to the
host.  Prints one JSON object: per dtype the host-clock time a request, the
device kernels' time a request by layer (convolutions; elementwise and
BatchNorm; pads, concats and copies; FFTs), the top kernels by name, and the
device's busy and idle share of the traced wall time.  A kernel's layer is
that of the outermost operator that launched it; its stage is the program's
own ``serve.*`` span around it (``runtime/profiling.py``, live under the
profiler: ``stft``, ``model``, ``phase``, ``istft``, ``transport``), ``other``
outside them.  Imports nothing of JAX.
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

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ml_audio_inpainting_torch.runtime import inference
from ml_audio_inpainting_torch.runtime.serve import make_gan_runner
from ml_audio_inpainting_torch.runtime.synthetic import (
    BATCH,
    GAP_LEN,
    GAP_START,
    gan_config,
    synthetic_dataset_batch,
)
from ml_audio_inpainting_torch.runtime.transport import DEFAULT_PATCH_WINDOW

REPO = Path(__file__).resolve().parents[1]
REQUESTS = 5
CHECKPOINT = REPO / "results" / "checkpoints" / "gan_formant_v2_r2.npz"
# Layer of an outermost operator, first match wins.  Casts (``aten::to``) count
# as elementwise; the iSTFT's overlap-add (``aten::index_add_``) as a copy.
LAYERS = (
    ("convolution", re.compile(r"conv")),
    ("fft", re.compile(r"fft")),
    ("pad_concat_copy", re.compile(r"pad|cat|copy|index|gather|upsample|fill|clone|contiguous|"
                                   r"unfold|expand|empty|zeros|repeat")),
    ("elementwise_batchnorm", re.compile(r"^aten::")),
)

# The program's span around a request, and the prefix of its stages' spans.
REQUEST = "serve.request"
STAGE = "serve."


def layer_of(op: str) -> str:
    for layer, pattern in LAYERS:
        if pattern.search(op):
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


def outermost(evt) -> tuple:
    """(stage, operator): the ``serve.*`` stage span around ``evt``
    (``other`` outside every stage) and the outermost operator inside it."""
    while evt.cpu_parent is not None and not evt.cpu_parent.name.startswith(STAGE):
        evt = evt.cpu_parent
    parent = evt.cpu_parent
    if parent is None or parent.name == REQUEST:
        return "other", evt.name
    return parent.name[len(STAGE):], evt.name


def profile_runner(runner, audio, starts, lens) -> dict:
    for _ in range(2):
        patch, start = runner(audio, starts, lens)
        patch.cpu(), start.cpu()
    torch.cuda.synchronize()
    request_ms = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_window = time.perf_counter()
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            patch, start = runner(audio, starts, lens)
            patch.cpu(), start.cpu()
            torch.cuda.synchronize()
            request_ms.append(1e3 * (time.perf_counter() - t0))
        window_ms = 1e3 * (time.perf_counter() - t_window)

    events = prof.events()
    by_layer, by_stage, by_name, intervals = (defaultdict(float), defaultdict(float),
                                              defaultdict(float), [])
    for evt in events:
        if evt.is_user_annotation:  # the spans themselves, on either timeline
            continue
        if evt.device_type == DeviceType.CUDA:
            intervals.append((evt.time_range.start, evt.time_range.end))
            by_name[evt.name] += (evt.time_range.end - evt.time_range.start) / 1e3
        elif evt.kernels:
            stage, op = outermost(evt)
            ms = sum(k.duration for k in evt.kernels) / 1e3
            by_layer[layer_of(op)] += ms
            by_stage[stage] += ms
    device_ms = sum(e - s for s, e in intervals) / 1e3
    attributed_ms = sum(by_layer.values())
    by_layer["unattributed"] = device_ms - attributed_ms
    busy_ms = busy_us(intervals) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "request_ms": request_ms,
        "window_ms": window_ms,
        "device_ms_per_request": {k: v / REQUESTS for k, v in sorted(by_layer.items())},
        "device_ms_per_request_by_stage": {k: v / REQUESTS for k, v in sorted(by_stage.items())},
        "device_ms_per_request_total": device_ms / REQUESTS,
        "device_busy_share": busy_ms / window_ms,
        "device_idle_share": 1.0 - busy_ms / window_ms,
        "top_kernels_ms_per_request": [[name[:120], ms / REQUESTS] for name, ms in top],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", default="oracle", choices=inference.PHASE_MODES)
    parser.add_argument("--dtype", default="both", choices=("f32", "bf16", "both"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script profiles the port on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    cfg = gan_config()
    audio = torch.tensor(synthetic_dataset_batch(BATCH, cfg.data.max_len_s), device="cuda")
    starts = torch.full((BATCH,), GAP_START, device="cuda")
    lens = torch.full((BATCH,), GAP_LEN, device="cuda")
    out = {"card": smi, "batch": BATCH, "requests": REQUESTS, "phase": args.phase}
    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        if args.dtype not in ("both", label):
            continue
        runner = make_gan_runner(cfg, CHECKPOINT, device="cuda", mode="enhanced",
                                 phase=args.phase, compute_dtype=dtype,
                                 transport_window=DEFAULT_PATCH_WINDOW)
        out[label] = profile_runner(runner, audio, starts, lens)
        del runner
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

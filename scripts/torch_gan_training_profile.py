#!/usr/bin/env python3
"""Where a GAN training step of the PyTorch port spends its time on one CUDA
card (the GAN training breakdown of PERF.md section 5).

    python3 -m scripts.torch_gan_training_profile                 # from the repo root
    python3 -m scripts.torch_gan_training_profile --dtype f32 --batch 8
    python3 -m scripts.torch_gan_training_profile --remat

Takes the JAX package's fastest GAN recipe (``train/recipe.py::
gan_recipe_config``: ``configs/gan.yaml`` with 4 gaps a clip, VGG19 on with
the port's seeded initialiser, EMA 0.999), at ``--batch`` clips of 5 s
(default 32) in ``--dtype`` (default bf16: f32 masters, bf16 networks),
with ``--remat`` recomputing the networks' activations in the backward;
the generator from the committed
``results/checkpoints/gan_formant_v2_r2.npz``, the discriminator seeded.
TF32 is off, as ``chip_smoke.py`` has it.  Warms up with two steps, then
traces ``STEPS`` steps on formant-corpus clips gathered on the card
(``data/pipeline.py::device_corpus_feed``) with ``torch.profiler``.

Prints one JSON object: the card, the host-clock time of each step, the
device kernels' time per step by kind (convolutions and their gradients,
cuDNN's layout transposes, matrix products, FFTs, the optimizer, pooling,
resizing, casts and copies, reductions, other elementwise passes, the
rest) and by part of the
step (the trainer's spans, ``train.G``, ``train.D``, ``train.VGG``,
``train.features``, ``train.backward`` (the host side of the gradients'
calls) and ``train.optimizer`` (Adam and the EMA), live under
the profiler, ``runtime/profiling.py``; a backward kernel is charged to
the span of the forward op it differentiates), the two crossed, the
device's busy and idle share of the traced wall time, and the top kernels.
Imports nothing of JAX.
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

from ml_audio_inpainting_torch.data.dataset import FormantSpeechDataset
from ml_audio_inpainting_torch.data.pipeline import device_corpus_feed
from ml_audio_inpainting_torch.models.vgg import vgg19_params
from ml_audio_inpainting_torch.train.gan_trainer import create_gan_states, make_gan_train_step
from ml_audio_inpainting_torch.train.recipe import gan_gap_layouts, gan_recipe_config
from ml_audio_inpainting_torch.weights import load_params_npz
from scripts.torch_cnn_serving_profile import busy_us

REPO = Path(__file__).resolve().parents[1]
CHECKPOINT = REPO / "results" / "checkpoints" / "gan_formant_v2_r2.npz"
STEPS = 3
EMA = 0.999
DTYPES = {"f32": None, "bf16": torch.bfloat16}
# Kind of a device kernel, by its name (first match wins).
KINDS = (
    # cuDNN's NCHW <-> NHWC transposes around its channels-last kernels.
    ("layout_transpose", re.compile(r"nchwToNhwc|nhwcToNchw|transpose", re.I)),
    # cuDNN's own FFT convolutions (fft2d_*, with cudnn:: arguments) are convolutions.
    ("convolution", re.compile(r"conv|fprop|dgrad|wgrad|implicit_gemm|winograd|cudnn|sm90_xmma",
                               re.I)),
    ("matmul", re.compile(r"gemm|sgemm|cutlass|xmma|cublas|matmul|nvjet", re.I)),
    ("fft", re.compile(r"fft", re.I)),
    ("optimizer", re.compile(r"adam|multi_tensor", re.I)),
    # The partial convolutions' mask sums (a sum pool) and VGG19's max pools.
    ("pooling", re.compile(r"pool", re.I)),
    # Nearest-neighbour upsampling in G, the antialiased resize before VGG19.
    ("resize", re.compile(r"upsample|interp", re.I)),
    ("copy_cast", re.compile(r"copy_kernel|bfloat16_copy", re.I)),
    ("reduction", re.compile(r"reduce_kernel", re.I)),
    ("elementwise", re.compile(r"elementwise_kernel", re.I)),
)
# The trainer's spans, by the part of the step each names.
PARTS = {f"train.{part}": part for part in ("features", "G", "D", "VGG", "backward",
                                           "optimizer")}
BACKWARD = "autograd::engine::evaluate_function"


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if pattern.search(name):
            return kind
    return "other"


def _root(evt):
    while evt.cpu_parent is not None:
        evt = evt.cpu_parent
    return evt


def _range_of(evt):
    """The innermost trainer range that ``evt`` runs in, or None."""
    while evt is not None:
        if evt.name in PARTS:
            return PARTS[evt.name]
        evt = evt.cpu_parent
    return None


def split_by_part(events) -> dict:
    """``{part: {kind: us}}`` of the device kernels that the CPU ops of
    ``events`` (``prof.events()``) launched.  A forward op's kernels go to
    the trainer range it ran in; a backward op's (under the autograd
    engine's ``evaluate_function``, or a checkpointed forward recomputed
    there) to the range of the forward op whose autograd node it
    evaluates, matched by sequence number and thread; the rest to
    ``"other"``."""
    forward_part = {}
    for evt in events:
        if evt.device_type == DeviceType.CPU and evt.sequence_nr >= 0:
            part = _range_of(evt)
            if part is not None and not _root(evt).name.startswith(BACKWARD):
                forward_part[(evt.sequence_nr, evt.thread)] = part
    out: dict = defaultdict(lambda: defaultdict(float))
    for evt in events:
        if evt.device_type != DeviceType.CPU or not evt.kernels:
            continue
        root = _root(evt)
        part = _range_of(evt)
        if root.name.startswith(BACKWARD):
            part = forward_part.get((root.sequence_nr, root.fwd_thread), part)
        for k in evt.kernels:
            out[part or "other"][kind_of(k.name)] += k.duration
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--remat", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script profiles the port on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    cfg = gan_recipe_config()
    cfg.training.batch_size = B = args.batch
    corpus = FormantSpeechDataset(n_items=2 * B, variant="v2", seed=0, cache=False)
    feed = device_corpus_feed(corpus, B, seed=0, device="cuda", workers=8)
    g, d = create_gan_states(cfg, device="cuda", generator=torch.Generator().manual_seed(0),
                             g_ema=EMA, params=load_params_npz(CHECKPOINT))
    step = make_gan_train_step(cfg, vgg=vgg19_params(device="cuda"),
                               compute_dtype=DTYPES[args.dtype], remat=args.remat, g_ema=EMA)
    gen = torch.Generator().manual_seed(7)
    batches = [(next(feed), [t.cuda() for t in gan_gap_layouts(gen, cfg, B)])
               for _ in range(2 + STEPS)]
    for audio, gaps in batches[:2]:
        g, d, m = step(g, d, audio, *gaps)
        m["g_total"].item()
    torch.cuda.synchronize()

    step_ms = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_window = time.perf_counter()
        for audio, gaps in batches[2:]:
            t0 = time.perf_counter()
            g, d, m = step(g, d, audio, *gaps)
            m["g_total"].item()  # synchronises
            step_ms.append(1e3 * (time.perf_counter() - t0))
        window_ms = 1e3 * (time.perf_counter() - t_window)

    events = prof.events()
    by_kind, by_name, intervals = defaultdict(float), defaultdict(float), []
    for evt in events:
        if evt.device_type != DeviceType.CUDA or evt.is_user_annotation:  # a span's shadow
            continue
        start, end = evt.time_range.start, evt.time_range.end
        intervals.append((start, end))
        by_kind[kind_of(evt.name)] += (end - start) / 1e3
        by_name[evt.name] += (end - start) / 1e3
    parts = split_by_part(events)
    kernel_ms = sum(by_kind.values())
    busy_ms = busy_us(intervals) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:30]
    print(json.dumps({
        "card": smi,
        "dtype": args.dtype,
        "batch": B,
        "remat": args.remat,
        "steps": STEPS,
        "step_ms": step_ms,
        "s_audio_per_s": B * cfg.data.max_len_s / (sorted(step_ms)[len(step_ms) // 2] / 1e3),
        "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
        "window_ms": window_ms,
        "device_kernel_ms_per_step": {k: v / STEPS for k, v in sorted(by_kind.items())},
        "device_kernel_ms_per_step_total": kernel_ms / STEPS,
        "device_ms_per_step_by_part": {
            part: {"total": sum(kinds.values()) / 1e3 / STEPS,
                   **{k: v / 1e3 / STEPS for k, v in sorted(kinds.items())}}
            for part, kinds in sorted(parts.items())},
        "device_busy_share": busy_ms / window_ms,
        "device_idle_share": 1.0 - busy_ms / window_ms,
        "top_kernels_ms_per_step": [[name[:120], ms / STEPS] for name, ms in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ml_audio_inpainting_torch``) on one NVIDIA
card: the quickest proof that the port builds, runs and agrees with itself.

    python3 chip_smoke.py

Phases, each printing one flushed line per step with the seconds since start:

1. device  -- the card's name, count and power limit (raises without CUDA);
2. build   -- one ``nvcc`` call builds ``csrc/lstm_fwd.cu``; prints the time
              and ptxas' register / shared-memory / spill report;
3. kernel  -- the LSTM kernel (both directions of a layer in one launch)
              against its plain PyTorch version at the serving shapes
              (B=32, T=417, H=128), TF32 off;
              CUDA-event times of both, and of cuDNN's ``nn.LSTM`` on layer
              1's shapes as the library yardstick (the port never calls it);
4. serving -- the CNN+BiLSTM runner with the committed
              ``results/checkpoints/cnn_blstm_formant_v2_r2.npz`` answers 3
              requests of 32 seeded speech-like 5 s clips with an 80 ms gap at
              2.0 s (``oracle``, ``oracle``, ``impaired``); the kernel's launch
              count must rise by 3 a request (one a layer, both directions in
              one launch); clip 0 is held against the port on the CPU.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``.  Any failure raises and the script
exits non-zero before the last line.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ml_audio_inpainting_torch.ops.cuda import lstm_cell
from ml_audio_inpainting_torch.ops.cuda.lstm_cell import (
    bilstm_recurrence,
    bilstm_recurrence_reference,
    load_library,
    lstm_recurrence_reference,
)
from ml_audio_inpainting_torch.ops.lstm import BiLSTM
from ml_audio_inpainting_torch.runtime.serve import make_cnn_runner
from ml_audio_inpainting_torch.runtime.synthetic import (
    BATCH,
    GAP_LEN,
    GAP_START,
    SAMPLE_RATE,
    speech_like_batch,
)
from ml_audio_inpainting_torch.utils.config import Config

DEVICE = "cuda"
REPO = Path(__file__).resolve().parent
CHECKPOINT = REPO / "results" / "checkpoints" / "cnn_blstm_formant_v2_r2.npz"
T0 = time.perf_counter()

# Published peaks of one H100 SXM (NVIDIA data sheet, at the full 700 W):
# HBM bandwidth, and f32 FMA outside the tensor cores (the kernel's math).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

B, T, H = BATCH, 417, 128  # serving shapes of one sweep
KERNEL_ATOL = 1e-4  # f32 dots over H=128 in the kernel's order vs cuBLAS', over 417 steps
CUDNN_ATOL = 1e-4  # the same, plus cuDNN's own projection and gate order
CPU_ATOL = 1e-4  # one clip on the card vs the CPU: every sum in another order


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {phase}: {msg}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs the port on an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
                  f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def phase_build() -> None:
    shutil.rmtree(lstm_cell.BUILD_DIR, ignore_errors=True)  # time a build from nothing
    lib = load_library()
    log("build", f"nvcc {' '.join(lstm_cell.NVCC_FLAGS)} -> {lib.path.name} "
                 f"in {lib.build_seconds:.2f} s")
    for line in lib.compiler_output.splitlines():
        if line.strip():
            log("build", f"  {line.strip()}")


def phase_kernel(card: str) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    bound = 1.0 / math.sqrt(H)
    xw_f, xw_b = (
        torch.tensor(rng.standard_normal((B, T, 4 * H)).astype(np.float32), device=dev)
        for _ in range(2)
    )
    w_f, w_b = (
        torch.tensor(rng.uniform(-bound, bound, (H, 4 * H)).astype(np.float32), device=dev)
        for _ in range(2)
    )

    # cuDNN's bidirectional LSTM on layer 1's shapes (input 2H=256), and the
    # port's projection + kernel for the same work, weights carried across.
    torch.manual_seed(0)
    x1 = torch.tensor(rng.standard_normal((B, T, 2 * H)).astype(np.float32), device=dev)
    cudnn = torch.nn.LSTM(2 * H, H, batch_first=True, bidirectional=True).to(dev)
    port = BiLSTM(2 * H, H, 1).to(dev)
    with torch.no_grad():
        port.load_state_dict({
            f"l0_{direction}_{name}": value
            for direction, suffix in (("fwd", ""), ("bwd", "_reverse"))
            for name, value in (
                ("w_ih", getattr(cudnn, f"weight_ih_l0{suffix}").T),
                ("w_hh", getattr(cudnn, f"weight_hh_l0{suffix}").T),
                ("b", getattr(cudnn, f"bias_ih_l0{suffix}") + getattr(cudnn, f"bias_hh_l0{suffix}")),
            )
        })

    with torch.inference_mode():
        # Each half of the kernel's output against the plain version of its
        # direction, then the times of both.
        got = bilstm_recurrence(xw_f, w_f, xw_b, w_b)
        torch.cuda.synchronize()
        max_err = 0.0
        for name, half, want in (
            ("forward", got[..., :H], lstm_recurrence_reference(xw_f, w_f, reverse=False)),
            ("backward", got[..., H:], lstm_recurrence_reference(xw_b, w_b, reverse=True)),
        ):
            err = (half - want).abs().max().item()
            log("kernel", f"{name}: max |kernel - plain| = {err:.3e} (atol {KERNEL_ATOL})")
            if not err <= KERNEL_ATOL:
                raise AssertionError(f"lstm_fwd ({name}) disagrees with its plain version: "
                                     f"{err} > {KERNEL_ATOL}")
            max_err = max(max_err, err)
        ms = cuda_ms(lambda: bilstm_recurrence(xw_f, w_f, xw_b, w_b), reps=50)
        plain_ms = cuda_ms(lambda: bilstm_recurrence_reference(xw_f, w_f, xw_b, w_b), reps=3, warmup=1)
        log("kernel", f"both directions, one launch: kernel {ms:.4f} ms, plain version "
                      f"{plain_ms:.3f} ms ({card})")

        # Library yardstick: cuDNN's bidirectional LSTM on layer 1's shapes.
        err = (port(x1) - cudnn(x1)[0]).abs().max().item()
        log("kernel", f"port BiLSTM layer vs cuDNN nn.LSTM: max abs err {err:.3e} (atol {CUDNN_ATOL})")
        if not err <= CUDNN_ATOL:
            raise AssertionError(f"port BiLSTM disagrees with cuDNN: {err} > {CUDNN_ATOL}")
        library_ms = cuda_ms(lambda: cudnn(x1), reps=20)
        port_layer_ms = cuda_ms(lambda: port(x1), reps=20)
    log("kernel", f"layer-1 BiLSTM (B={B}, T={T}, 256->2x{H}): cuDNN nn.LSTM {library_ms:.4f} ms, "
                  f"port projection + kernel {port_layer_ms:.4f} ms ({card})")

    # Both directions: xw and W_hh read once, h written once; h @ W_hh each step.
    bytes_moved = 2 * 4 * (B * T * 4 * H + H * 4 * H + B * T * H)
    flops = 2 * 2 * B * T * H * 4 * H
    bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
    bound_by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= flops / F32_FLOP_PER_S else "operations"
    log("kernel", f"bound {bound_ms:.5f} ms by {bound_by} ({bytes_moved / 1e6:.1f} MB, "
                  f"{flops / 1e9:.3f} GFLOP at H100 SXM peaks)")
    return {
        "name": "lstm_fwd",
        "route": "cuda",
        "source": "ml_audio_inpainting_torch/csrc/lstm_fwd.cu",
        "replaces": "ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py:40",
        "launches": None,  # filled from the serving run
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "library_call": "torch.nn.LSTM(256, 128, bidirectional=True), layer-1 shapes: "
                        "projection and both directions",
        "port_same_work_ms": port_layer_ms,
        "shapes": {"B": B, "T": T, "H": H, "directions": 2},
    }


def phase_serving(card: str) -> int:
    cfg = Config()
    n_samples = cfg.data.max_samples
    runners = {
        phase: make_cnn_runner(cfg, CHECKPOINT, device=DEVICE, phase=phase)
        for phase in ("oracle", "impaired")
    }
    audio = speech_like_batch(np.random.default_rng(1), B)
    gap_start = np.full(B, GAP_START)
    gap_len = np.full(B, GAP_LEN)
    log("serving", f"runners built from {CHECKPOINT.name}; batch {audio.shape}, gap "
                   f"[{GAP_START}, {GAP_START + GAP_LEN}) samples")

    torch.cuda.reset_peak_memory_stats()
    bilstm_recurrence.launches = 0
    outputs = []
    for i, phase in enumerate(("oracle", "oracle", "impaired")):
        before = bilstm_recurrence.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = runners[phase](audio, gap_start, gap_len)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = bilstm_recurrence.launches - before
        if launched != 3:
            raise AssertionError(
                f"request {i}: lstm_fwd launched {launched} times, expected 3 "
                "(one per layer, both directions a launch)"
            )
        if tuple(restored.shape) != (B, n_samples) or not torch.isfinite(restored).all():
            raise AssertionError(f"request {i}: restored {tuple(restored.shape)} not finite/shaped")
        outputs.append(restored)
        log("serving", f"request {i} ({phase}): {1e3 * seconds:.2f} ms, "
                       f"{B * n_samples / SAMPLE_RATE / seconds:.1f} s-audio/s, "
                       f"{launched} lstm_fwd launches ({card})")
    launches = bilstm_recurrence.launches
    log("serving", f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})")

    # Outside the gap's frames the output is the input: impaired exactly,
    # oracle up to the 1e-9 floor of the log10 magnitude.
    lo, hi = GAP_START - 512, GAP_START + GAP_LEN + 512
    outside = torch.ones(n_samples, dtype=torch.bool, device=DEVICE)
    outside[lo:hi] = False
    audio_d = torch.tensor(audio, device=DEVICE)
    err_o = (outputs[0] - audio_d)[:, outside].abs().max().item()
    if not torch.equal(outputs[2][:, outside], audio_d[:, outside]) or not err_o <= 1e-3:
        raise AssertionError(f"output differs from the input away from the gap (oracle {err_o})")

    # Clip 0 through the port on the CPU.
    for i, phase in ((0, "oracle"), (2, "impaired")):
        cpu = make_cnn_runner(cfg, CHECKPOINT, device="cpu", phase=phase)
        want = cpu(audio[:1], gap_start[:1], gap_len[:1])
        err = (outputs[i][:1].cpu() - want).abs().max().item()
        log("serving", f"clip 0 ({phase}) card vs CPU: max abs err {err:.3e} (atol {CPU_ATOL})")
        if not err <= CPU_ATOL:
            raise AssertionError(f"card and CPU disagree on clip 0 ({phase}): {err} > {CPU_ATOL}")
    return launches


def main() -> int:
    smi = phase_device()
    card = f"{torch.cuda.get_device_name(0)}, power limit {smi.split(',')[-1].strip()}"
    phase_build()
    kernel = phase_kernel(card)
    kernel["launches"] = phase_serving(card)
    log("done", f"total {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

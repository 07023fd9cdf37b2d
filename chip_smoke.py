#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ml_audio_inpainting_torch``) on one NVIDIA
card: the quickest proof that the port builds, runs and agrees with itself.

    python3 chip_smoke.py

Phases, each printing one flushed line per step with the seconds since start:

1. device     -- the card's name, count and power limit (raises without CUDA);
2. build      -- one ``nvcc`` call a source, ``csrc/lstm_fwd.cu`` and
                 ``csrc/lstm_bwd.cu``, started together; prints the times and
                 ptxas' register / shared-memory / spill reports;
3. kernel     -- the forward LSTM kernel ``lstm_fwd`` (both directions of a
                 layer in one launch) against its plain PyTorch version at the
                 serving shapes (B=32, T=417, H=128), TF32 off; CUDA-event
                 times of both, and of cuDNN's ``nn.LSTM`` on layer 1's shapes
                 as the library yardstick (the port never calls it);
4. kernel_bwd -- the backward kernels ``lstm_bwd`` (reverse-time sweep, one
                 thread-block cluster per 4 batch rows and direction) and
                 ``lstm_dwhh`` (split-K dW_hh reduction, two passes) against
                 the plain backward at the training shapes (B=25, T=417,
                 H=128, both directions), TF32 off; two launches must agree
                 bit for bit; the launch plans (cluster, grid, shared memory)
                 and ptxas' registers and spills; CUDA-event times, the plain
                 version's (for dW_hh a cuBLAS product), ``torch.bmm`` for
                 dW_hh, and cuDNN's ``nn.LSTM`` backward on layer 1's shapes
                 beside the port's projection + ``lstm_fwd`` + ``lstm_bwd`` +
                 ``lstm_dwhh``; then the same kernels checked and timed once at
                 B=128, the batch of ``cnn_blstm_formant_v2_b128_r4.npz``;
5. serving    -- the CNN+BiLSTM runner with the committed
                 ``results/checkpoints/cnn_blstm_formant_v2_r2.npz`` answers 3
                 requests of 32 seeded speech-like 5 s clips with an 80 ms gap
                 at 2.0 s (``oracle``, ``oracle``, ``impaired``); ``lstm_fwd``
                 must launch 3 times a request (one a layer, both directions in
                 one launch) and the backward kernels never; clip 0 is held
                 against the port on the CPU;
6. training   -- the recipe of ``configs/cnn_blstm.yaml`` (1 clip x 25 gap
                 variants of 0.2 s, Adam at lr 1e-4, full width) takes 5 steps
                 on seeded clips and gap starts, twice: from the committed
                 checkpoint, and from it with its BiLSTM weights redrawn
                 (the checkpoint's BiLSTM is saturated, so no gradient
                 reaches it or the encoder, in either package).  Each step
                 must launch every kernel 3 times (one a BiLSTM layer) and
                 give a finite loss; every parameter with a gradient must
                 move (from the redrawn BiLSTM: every parameter); step 0's
                 loss and gradients on a reduced batch (1 clip x 2 variants)
                 are held against the port's step in float64 on the CPU from
                 both starts; the
                 trained weights are exported to the JAX package's npz format
                 and serve one request.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``.  Any failure raises and the script
exits non-zero before the last line.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ml_audio_inpainting_torch.ops.cuda import lstm_cell
from ml_audio_inpainting_torch.ops.cuda.lstm_cell import (
    BWD_THREADS,
    bilstm_dwhh,
    bilstm_forward,
    bilstm_recurrence,
    bilstm_recurrence_backward,
    bilstm_recurrence_reference,
    bwd_plan,
    dwhh_plan,
    dwhh_reference,
    load_library,
    lstm_recurrence_backward_reference,
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
from ml_audio_inpainting_torch.train.checkpoints import export_params_npz
from ml_audio_inpainting_torch.train.cnn_trainer import create_cnn_state, make_cnn_train_step
from ml_audio_inpainting_torch.train.recipe import gap_starts, live_bilstm, recipe_config
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.weights import load_params_npz

DEVICE = "cuda"
REPO = Path(__file__).resolve().parent
CHECKPOINT = REPO / "results" / "checkpoints" / "cnn_blstm_formant_v2_r2.npz"
T0 = time.perf_counter()

# Published peaks of one H100 SXM (NVIDIA data sheet, at the full 700 W):
# HBM bandwidth, and f32 FMA outside the tensor cores (the kernel's math).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

B, T, H = BATCH, 417, 128  # serving shapes of one sweep
B_TRAIN = 25  # the training recipe's 1 clip x 25 gap variants
B_LARGE = 128  # the batch of cnn_blstm_formant_v2_b128_r4.npz
KERNEL_ATOL = 1e-4  # f32 dots over H=128 in the kernel's order vs cuBLAS', over 417 steps
CUDNN_ATOL = 1e-4  # the same, plus cuDNN's own projection and gate order
CPU_ATOL = 1e-4  # one clip on the card vs the CPU: every sum in another order
# lstm_bwd's dxw against the plain backward: f32 dots over H and 4H in another
# order, carried through 417 reverse steps.
DXW_ATOL = 1e-4
# lstm_dwhh's dW_hh: a sum of B*T = 10 425 outer products in another order
# than cuBLAS', held within 1e-4 of the largest entry of dW_hh.
DWHH_RTOL_OF_MAX = 1e-4
# Training step 0 on the card in f32 vs the port's step in f64 on the CPU
# (1 clip x 2 variants, full width, TF32 off, the same weights and inputs):
# the loss to 1e-4 relative; each gradient tensor within 1e-3 of its largest
# entry.  What is left is the card's own f32 rounding; the worst tensor is
# the most ill-conditioned, a BatchNorm bias's gradient (a sum of 214 000
# terms of both signs): on an H100, enc_bn1.bias from the redrawn BiLSTM
# lies 6.5e-4 of its largest entry from f64 (the same in repeated runs; the
# port's f32 step on the CPU, 4.3e-4), and 1e-3 leaves 1.5x that for another
# choice of cuDNN algorithm, whose sums run in another order.  The conv biases in front of BatchNorm have an exact
# gradient of zero (the batch mean removes them), so theirs are the card's
# rounding noise and are held within the same bound of the model's largest
# gradient entry; so are the tensors whose f64 gradient lies below f32's
# resolution of it (from the committed checkpoint the saturated BiLSTM's,
# ~1e-13 of it in f64 and exactly zero in f32).
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL_OF_MAX = 1e-3
F32_EPS = float(np.finfo(np.float32).eps)
NOISE_GRAD = {"enc_conv0.bias", "enc_conv1.bias", "enc_conv2.bias", "dec_conv0.bias",
              "dec_conv1.bias"}
TRAIN_STEPS = 5


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


def ptxas_report(output: str) -> dict:
    """Kernel name -> registers, static shared memory, stack frame and
    spills, from ptxas' ``-v`` report."""
    report, name = {}, None
    for line in output.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:  # the mangled name holds <length><name>
            found = re.search(r"(\d+)(lstm_\w+)", m.group(1))
            name = found.group(2)[: int(found.group(1))] if found else m.group(1)
            report[name] = {"registers": 0, "smem_bytes": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[name].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            report[name]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return report


def phase_build() -> dict:
    """Builds every source from nothing, in parallel; returns ptxas' report
    of every kernel."""
    shutil.rmtree(lstm_cell.BUILD_DIR, ignore_errors=True)  # time a build from nothing
    names = list(lstm_cell.SOURCES)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc a source, all at once
        libs = dict(zip(names, pool.map(load_library, names)))
    log("build", f"{len(names)} sources in {time.perf_counter() - t0:.2f} s (in parallel)")
    report = {}
    for name, lib in libs.items():
        log("build", f"nvcc {' '.join(lstm_cell.NVCC_FLAGS)} {name}.cu -> {lib.path.name} "
                     f"in {lib.build_seconds:.2f} s")
        for line in lib.compiler_output.splitlines():
            if line.strip():
                log("build", f"  {line.strip()}")
        report.update(ptxas_report(lib.compiler_output))
    for kernel, r in report.items():
        log("build", f"{kernel}: {r}")
    return report


def roofline(bytes_moved: float, flops: float) -> tuple:
    """(ms, "bytes" or "operations"): the least time at the H100's peaks."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel(card: str, ptxas: dict) -> dict:
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
    bound_ms, bound_by = roofline(bytes_moved, flops)
    log("kernel", f"bound {bound_ms:.5f} ms by {bound_by} ({bytes_moved / 1e6:.1f} MB, "
                  f"{flops / 1e9:.3f} GFLOP at H100 SXM peaks)")
    return {
        "name": "lstm_fwd",
        "route": "cuda",
        "source": "ml_audio_inpainting_torch/csrc/lstm_fwd.cu",
        "replaces": "ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py:40",
        "launches": None,  # filled from the main paths' runs
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
        "ptxas": ptxas.get("lstm_fwd_kernel"),
    }


def _backward_inputs(b: int, seed: int) -> tuple:
    """Seeded (xw_f, w_f, xw_b, w_b) and incoming gradient g of a layer on
    the card, and lstm_fwd's (h, c) of them."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    scale = 1.0 / math.sqrt(H)
    xw_f, xw_b = (torch.tensor(rng.standard_normal((b, T, 4 * H)).astype(np.float32), device=dev)
                  for _ in range(2))
    w_f, w_b = (torch.tensor(rng.uniform(-scale, scale, (H, 4 * H)).astype(np.float32),
                             device=dev) for _ in range(2))
    g = torch.tensor(rng.standard_normal((b, T, 2 * H)).astype(np.float32), device=dev)
    h, c = bilstm_forward(xw_f, w_f, xw_b, w_b, with_c=True)
    return (xw_f, w_f, xw_b, w_b), g, h, c


def _check_backward(label: str, layer: tuple, g, h, c, dxw: tuple, dw: tuple) -> tuple:
    """Each direction's dxw and dW_hh against the plain backward; returns the
    largest dxw error and the largest dW_hh error relative to max |dW_hh|."""
    xw_f, w_f, xw_b, w_b = layer
    err_dxw = err_dw = 0.0
    for name, sl, xw, w, d_xw, d_w, reverse in (
        ("forward", slice(0, H), xw_f, w_f, dxw[0], dw[0], False),
        ("backward", slice(H, 2 * H), xw_b, w_b, dxw[1], dw[1], True),
    ):
        want_dxw = lstm_recurrence_backward_reference(
            xw, w, h[..., sl], c[..., sl], g[..., sl], reverse=reverse)
        want_dw = dwhh_reference(h[..., sl], want_dxw, reverse)
        e_dxw = (d_xw - want_dxw).abs().max().item()
        e_dw = (d_w - want_dw).abs().max().item()
        dw_max = want_dw.abs().max().item()
        log("kernel_bwd", f"{label} {name}: max |dxw - plain| = {e_dxw:.3e} (atol {DXW_ATOL}); "
                          f"max |dW_hh - plain| = {e_dw:.3e} of max |dW_hh| {dw_max:.3e} "
                          f"(allowed {DWHH_RTOL_OF_MAX} of it)")
        if not e_dxw <= DXW_ATOL:
            raise AssertionError(f"lstm_bwd ({label} {name}) disagrees with its plain version: "
                                 f"{e_dxw} > {DXW_ATOL}")
        if not e_dw <= DWHH_RTOL_OF_MAX * dw_max:
            raise AssertionError(f"lstm_dwhh ({label} {name}) disagrees with its plain version: "
                                 f"{e_dw} > {DWHH_RTOL_OF_MAX} x {dw_max}")
        err_dxw, err_dw = max(err_dxw, e_dxw), max(err_dw, e_dw / dw_max)
    return err_dxw, err_dw


def _backward_bounds(b: int) -> tuple:
    """((ms, by) of lstm_bwd, (ms, by) of lstm_dwhh) at batch b, both
    directions.  lstm_bwd: xw, W_hh, h, c, g read once, dxw written once;
    two (B,H)x(H,4H) products a step (gates, dh).  lstm_dwhh: h and dxw read
    once, dW_hh written once; one product of depth B*T."""
    f4 = 4
    bwd_bytes = 2 * f4 * (b * T * 4 * H + H * 4 * H + b * T * 4 * H) + 3 * f4 * b * T * 2 * H
    bwd_flops = 2 * 2 * (2 * b * T * H * 4 * H)
    dwhh_bytes = f4 * (b * T * 2 * H + 2 * b * T * 4 * H + 2 * H * 4 * H)
    dwhh_flops = 2 * (2 * b * T * H * 4 * H)
    log("kernel_bwd", f"B={b}: lstm_bwd moves {bwd_bytes / 1e6:.1f} MB and does "
                      f"{bwd_flops / 1e9:.3f} GFLOP; lstm_dwhh {dwhh_bytes / 1e6:.1f} MB, "
                      f"{dwhh_flops / 1e9:.3f} GFLOP")
    return roofline(bwd_bytes, bwd_flops), roofline(dwhh_bytes, dwhh_flops)


def phase_kernel_bwd(card: str, ptxas: dict) -> list:
    """lstm_bwd and lstm_dwhh against the plain backward at the training
    shapes and at B=128; determinism; their launch plans, times, bounds and
    the library yardsticks."""
    dev = torch.device(DEVICE)
    b = B_TRAIN
    layer, g, h, c = _backward_inputs(b, seed=2)
    xw_f, w_f, xw_b, w_b = layer
    with torch.no_grad():
        dxw_f, dxw_b = bilstm_recurrence_backward(*layer, h, c, g)
        dw_f, dw_b = bilstm_dwhh(h, dxw_f, dxw_b)
        torch.cuda.synchronize()
        err_dxw, err_dw = _check_backward(f"B={b}", layer, g, h, c, (dxw_f, dxw_b), (dw_f, dw_b))

        # Two launches on the same inputs: bit for bit the same.
        again = bilstm_recurrence_backward(*layer, h, c, g)
        again = (*again, *bilstm_dwhh(h, *again))
        same = [torch.equal(x, y) for x, y in zip((dxw_f, dxw_b, dw_f, dw_b), again)]
        log("kernel_bwd", f"second launch bitwise equal (dxw_f, dxw_b, dW_f, dW_b): {same}")
        if not all(same):
            raise AssertionError(f"the backward kernels are not deterministic: {same}")

        bwd_ms = cuda_ms(lambda: bilstm_recurrence_backward(*layer, h, c, g), reps=20)
        dwhh_ms = cuda_ms(lambda: bilstm_dwhh(h, dxw_f, dxw_b), reps=50)
        plain_bwd_ms = cuda_ms(lambda: [lstm_recurrence_backward_reference(
            xw, w, h[..., sl], c[..., sl], g[..., sl], reverse=rev)
            for xw, w, sl, rev in ((xw_f, w_f, slice(0, H), False),
                                   (xw_b, w_b, slice(H, 2 * H), True))], reps=3, warmup=1)
        # The plain dW_hh: shifted copies of h and one cuBLAS product a direction.
        plain_dwhh_ms = cuda_ms(lambda: (dwhh_reference(h[..., :H], dxw_f, False),
                                         dwhh_reference(h[..., H:], dxw_b, True)), reps=20)
        # The reduction as one library call: a batched product over pre-shifted h.
        hp = torch.stack([
            torch.cat([torch.zeros_like(h[:, :1, :H]), h[:, :-1, :H]], dim=1),
            torch.cat([h[:, 1:, H:], torch.zeros_like(h[:, :1, H:])], dim=1),
        ]).reshape(2, b * T, H)
        dxw_both = torch.stack([dxw_f, dxw_b]).reshape(2, b * T, 4 * H)
        lib_dwhh = torch.bmm(hp.transpose(1, 2), dxw_both)
        e_lib = (lib_dwhh - torch.stack([dw_f, dw_b])).abs().max().item()
        log("kernel_bwd", f"dW_hh kernel vs torch.bmm on shifted h: max abs err {e_lib:.3e}")
        library_dwhh_ms = cuda_ms(lambda: torch.bmm(hp.transpose(1, 2), dxw_both), reps=50)
        del hp, dxw_both, lib_dwhh, again
    log("kernel_bwd", f"lstm_bwd {bwd_ms:.4f} ms (plain {plain_bwd_ms:.3f} ms), lstm_dwhh "
                      f"{dwhh_ms:.4f} ms, both passes (plain, cuBLAS on shifted copies, "
                      f"{plain_dwhh_ms:.4f} ms; torch.bmm {library_dwhh_ms:.4f} ms) at B={b}, "
                      f"T={T}, H={H}, both directions ({card})")

    # The batch of cnn_blstm_formant_v2_b128_r4.npz: 64 clusters a direction,
    # more CTAs than SMs.  Checked once, then timed.
    layer_l, g_l, h_l, c_l = _backward_inputs(B_LARGE, seed=3)
    with torch.no_grad():
        dxw_l = bilstm_recurrence_backward(*layer_l, h_l, c_l, g_l)
        dw_l = bilstm_dwhh(h_l, *dxw_l)
        torch.cuda.synchronize()
        err_l = _check_backward(f"B={B_LARGE}", layer_l, g_l, h_l, c_l, dxw_l, dw_l)
        bwd_l_ms = cuda_ms(lambda: bilstm_recurrence_backward(*layer_l, h_l, c_l, g_l), reps=10)
        dwhh_l_ms = cuda_ms(lambda: bilstm_dwhh(h_l, *dxw_l), reps=20)
    (bwd_l_bound, _), (dwhh_l_bound, _) = _backward_bounds(B_LARGE)
    log("kernel_bwd", f"B={B_LARGE}: lstm_bwd {bwd_l_ms:.4f} ms (bound {bwd_l_bound:.5f}), "
                      f"lstm_dwhh {dwhh_l_ms:.4f} ms (bound {dwhh_l_bound:.5f}) ({card})")
    del layer_l, g_l, h_l, c_l, dxw_l, dw_l

    # The launch plans at the training shapes.
    bp, dp = bwd_plan(b, H), dwhh_plan(b, T, H)
    smem = load_library("lstm_bwd").cdll.lstm_bwd_smem_bytes(H, bp.cluster, bp.ksplit)
    bwd_launch = {"cluster": bp.cluster, "grid": list(bp.grid), "threads": BWD_THREADS,
                  "dynamic_smem_bytes": smem, "units_per_cta": bp.units, "ksplit": bp.ksplit}
    dwhh_launch = {"grid": list(dp.grid), "threads": BWD_THREADS, "slices": dp.slices,
                   "rows_per_slice": dp.rows_per_slice,
                   "partials_shape": list(dp.partial_shape)}
    log("kernel_bwd", f"lstm_bwd launch at B={b}: {bwd_launch}; ptxas "
                      f"{ptxas.get('lstm_bwd_kernel')}")
    log("kernel_bwd", f"lstm_dwhh launch at B={b}: {dwhh_launch}; ptxas "
                      f"{ptxas.get('lstm_dwhh_partial_kernel')} and "
                      f"{ptxas.get('lstm_dwhh_reduce_kernel')}")

    # Library yardstick: cuDNN's bidirectional LSTM backward on layer 1's
    # shapes (fwd+bwd minus fwd), beside the port's layer for the same work.
    rng = np.random.default_rng(4)
    torch.manual_seed(0)
    x1 = torch.tensor(rng.standard_normal((b, T, 2 * H)).astype(np.float32), device=dev,
                      requires_grad=True)
    gout = torch.tensor(rng.standard_normal((b, T, 2 * H)).astype(np.float32), device=dev)
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
    grads = {}
    for name, layer_fn in (("cudnn", lambda: cudnn(x1)[0]), ("port", lambda: port(x1))):
        params = list(cudnn.parameters() if name == "cudnn" else port.parameters())
        grads[name] = torch.autograd.grad(layer_fn(), [x1, *params], gout)
    e_dx = (grads["port"][0] - grads["cudnn"][0]).abs().max().item()
    log("kernel_bwd", f"port BiLSTM layer backward vs cuDNN: max |dx| err {e_dx:.3e} "
                      f"(atol {CUDNN_ATOL})")
    if not e_dx <= CUDNN_ATOL:
        raise AssertionError(f"port BiLSTM backward disagrees with cuDNN: {e_dx} > {CUDNN_ATOL}")

    def fwd_bwd(layer_fn, params):
        return lambda: torch.autograd.grad(layer_fn(), [x1, *params], gout)

    # Forwards with grad on, as in training (the port's then keeps c).
    cudnn_f = cuda_ms(lambda: cudnn(x1), reps=10)
    port_f = cuda_ms(lambda: port(x1), reps=10)
    cudnn_fb = cuda_ms(fwd_bwd(lambda: cudnn(x1)[0], list(cudnn.parameters())), reps=10)
    port_fb = cuda_ms(fwd_bwd(lambda: port(x1), list(port.parameters())), reps=10)
    library_ms = cudnn_fb - cudnn_f
    log("kernel_bwd", f"layer-1 BiLSTM (B={b}, T={T}, 256->2x{H}): cuDNN nn.LSTM forward "
                      f"{cudnn_f:.4f} ms, forward+backward {cudnn_fb:.4f} ms (backward "
                      f"{library_ms:.4f} ms); port forward {port_f:.4f} ms, forward+backward "
                      f"{port_fb:.4f} ms (backward {port_fb - port_f:.4f} ms) ({card})")

    (bwd_bound, bwd_by), (dwhh_bound, dwhh_by) = _backward_bounds(b)
    log("kernel_bwd", f"bounds at B={b}: lstm_bwd {bwd_bound:.5f} ms by {bwd_by}; lstm_dwhh "
                      f"{dwhh_bound:.5f} ms by {dwhh_by} (H100 SXM peaks)")
    shapes = {"B": b, "T": T, "H": H, "directions": 2}
    return [
        {
            "name": "lstm_bwd",
            "route": "cuda",
            "source": "ml_audio_inpainting_torch/csrc/lstm_bwd.cu",
            "replaces": "ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py:64",
            "launches": None,
            "max_abs_err": err_dxw,
            "ms": bwd_ms,
            "plain_ms": plain_bwd_ms,
            "bound_ms": bwd_bound,
            "bound_by": bwd_by,
            "library_ms": library_ms,
            "library_call": "torch.nn.LSTM(256, 128, bidirectional=True) backward, layer-1 "
                            "shapes (forward+backward minus forward)",
            "port_same_work_ms": port_fb - port_f,
            "shapes": shapes,
            "launch": bwd_launch,
            "ptxas": ptxas.get("lstm_bwd_kernel"),
            "deterministic": True,
            "b128": {"ms": bwd_l_ms, "bound_ms": bwd_l_bound, "max_abs_err": err_l[0]},
        },
        {
            "name": "lstm_dwhh",
            "route": "cuda",
            "source": "ml_audio_inpainting_torch/csrc/lstm_bwd.cu",
            "replaces": "ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py:109",
            "launches": None,
            "max_abs_err": err_dw,
            "max_abs_err_is": "relative to max |dW_hh|",
            "ms": dwhh_ms,
            "plain_ms": plain_dwhh_ms,
            "plain_is": "dwhh_reference: shifted copies of h and one cuBLAS product a direction",
            "bound_ms": dwhh_bound,
            "bound_by": dwhh_by,
            "library_ms": library_dwhh_ms,
            "library_call": "torch.bmm of the shifted h_prev^T and dxw, both directions",
            "passes": ["lstm_dwhh_partial_kernel", "lstm_dwhh_reduce_kernel"],
            "shapes": shapes,
            "launch": dwhh_launch,
            "ptxas": {k: ptxas.get(k) for k in ("lstm_dwhh_partial_kernel",
                                                  "lstm_dwhh_reduce_kernel")},
            "deterministic": True,
            "b128": {"ms": dwhh_l_ms, "bound_ms": dwhh_l_bound, "max_abs_err": err_l[1]},
        },
    ]


def _counts() -> dict:
    return {"lstm_fwd": bilstm_recurrence.launches,
            "lstm_bwd": bilstm_recurrence_backward.launches,
            "lstm_dwhh": bilstm_dwhh.launches}


def _reset_counts() -> None:
    bilstm_recurrence.launches = 0
    bilstm_recurrence_backward.launches = 0
    bilstm_dwhh.launches = 0


def phase_serving(card: str) -> dict:
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
    _reset_counts()
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
    launches = _counts()
    if launches["lstm_bwd"] or launches["lstm_dwhh"]:
        raise AssertionError(f"serving launched a backward kernel: {launches}")
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


def _check_step_against_cpu(cfg: Config, flat: dict, audio: np.ndarray, starts: torch.Tensor,
                            label: str) -> dict:
    """Step 0 of a reduced batch on the card in f32 and on the CPU in f64
    from the same weights and inputs: the loss and every gradient tensor.
    Returns the names of the tensors whose gradient is exactly zero on the
    card."""
    out = {}
    for side, device, dtype in (("card", DEVICE, torch.float32), ("cpu", "cpu", torch.float64)):
        state = create_cnn_state(cfg, device=device, params=flat)
        state.model.to(dtype)
        _, m = make_cnn_train_step(cfg)(state, torch.tensor(audio, device=device, dtype=dtype),
                                        starts.to(device))
        out[side] = (m["loss"].item(), {n: p.grad.detach().cpu().double()
                                        for n, p in state.model.named_parameters()})
    (loss_d, g_d), (loss_c, g_c) = out["card"], out["cpu"]
    rel = abs(loss_d - loss_c) / abs(loss_c)
    log("training", f"{label}: step 0 of {tuple(starts.shape)} clips x variants: loss card "
                    f"{loss_d:.6f}, CPU f64 {loss_c:.6f}, relative difference {rel:.3e} "
                    f"(rtol {STEP_LOSS_RTOL})")
    if not rel <= STEP_LOSS_RTOL:
        raise AssertionError(f"{label} step 0 loss: card {loss_d} vs CPU {loss_c}")
    g_max = max(g.abs().max().item() for g in g_c.values())
    worst = (0.0, "")
    for name, want in g_c.items():
        own = want.abs().max().item()
        scale = g_max if name in NOISE_GRAD or own <= F32_EPS * g_max else own
        err = (g_d[name] - want).abs().max().item()
        if not err <= STEP_GRAD_RTOL_OF_MAX * scale:
            raise AssertionError(f"{label} step 0 gradient {name}: card vs CPU max err {err} > "
                                 f"{STEP_GRAD_RTOL_OF_MAX} x {scale}")
        if scale > 0 and err / scale > worst[0]:
            worst = (err / scale, name)
    zero = sorted(n for n, g in g_d.items() if not g.any())
    log("training", f"{label}: step 0 gradients, {len(g_c)} tensors: card vs CPU f64 within "
                    f"{worst[0]:.3e} of their largest entry (worst {worst[1]}; allowed "
                    f"{STEP_GRAD_RTOL_OF_MAX}); exactly zero on the card: {len(zero)} tensors")
    return {"loss_rel_err": rel, "grad_rel_err": worst[0], "zero_grad": zero}


def _train(card: str, cfg: Config, flat: dict, label: str, clips: list, starts: list) -> tuple:
    """TRAIN_STEPS steps from ``flat``; asserts the launches of every step and
    finite losses.  Returns the state, the launch counts, the names of the
    parameter tensors that moved and of all of them."""
    G = cfg.data.gaps_per_audio
    state = create_cnn_state(cfg, device=DEVICE, params=flat)
    step = make_cnn_train_step(cfg)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    seconds = []
    for i in range(TRAIN_STEPS):
        counts = _counts()
        audio = torch.tensor(clips[i], device=DEVICE)
        gs = starts[i].to(DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, audio, gs)
        loss = metrics["loss"].item()  # synchronises
        seconds.append(time.perf_counter() - t0)
        launched = {k: v - counts[k] for k, v in _counts().items()}
        if launched != {"lstm_fwd": 3, "lstm_bwd": 3, "lstm_dwhh": 3}:
            raise AssertionError(f"{label} training step {i}: launches {launched}, expected 3 "
                                 "of each (one a BiLSTM layer)")
        if not math.isfinite(loss):
            raise AssertionError(f"{label} training step {i}: loss {loss}")
        log("training", f"{label}: step {i}: loss {loss:.4f}, {1e3 * seconds[-1]:.2f} ms, "
                        f"{G / seconds[-1]:.1f} sequences/s, launches {launched} ({card})")
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    warm = sorted(seconds[1:])[len(seconds[1:]) // 2]
    log("training", f"{label}: warm step (median of steps 1-{TRAIN_STEPS - 1}) "
                    f"{1e3 * warm:.2f} ms, {G / warm:.1f} sequences/s, "
                    f"{G * cfg.data.max_len_s / warm:.1f} s-audio/s; first step "
                    f"{1e3 * seconds[0]:.2f} ms; peak device memory {peak:.1f} MiB ({card})")
    moved = {n for n, p in state.model.named_parameters() if not torch.equal(p, before[n])}
    return state, launches, moved, set(before)


def phase_training(card: str) -> dict:
    cfg = recipe_config()
    G = cfg.data.gaps_per_audio
    flat = load_params_npz(CHECKPOINT)
    live = live_bilstm(flat, seed=6)
    clips = [speech_like_batch(np.random.default_rng(100 + i), 1) for i in range(TRAIN_STEPS)]
    gen = torch.Generator().manual_seed(5)
    starts = [gap_starts(gen, cfg, 1, G) for _ in range(TRAIN_STEPS)]
    log("training", f"{TRAIN_STEPS} steps of 1 clip x {G} gap variants of "
                    f"{cfg.data.gap_len_s} s, lr {cfg.training.starter_learning_rate}, from "
                    f"{CHECKPOINT.name} and from it with its BiLSTM redrawn")

    # From the committed checkpoint: what has a gradient moves, and what has
    # none on the card has, in f64 on the CPU, none that f32 could resolve
    # (the gradient check allows a card's zero nowhere else).
    check = _check_step_against_cpu(cfg, flat, clips[0], starts[0][:, :2], "checkpoint")
    _, launches, moved, names = _train(card, cfg, flat, "checkpoint", clips, starts)
    if moved != names - set(check["zero_grad"]):
        raise AssertionError(f"checkpoint run: moved {sorted(moved)}, zero gradient at step 0 "
                             f"{check['zero_grad']}")
    log("training", f"checkpoint: {len(moved)} of {len(names)} tensors moved; no gradient "
                    f"reaches (below f32's resolution in f64 on the CPU) {check['zero_grad']}")

    # From the live BiLSTM: every parameter moves.
    live_check = _check_step_against_cpu(cfg, live, clips[0], starts[0][:, :2], "live BiLSTM")
    if live_check["zero_grad"]:
        raise AssertionError(f"live BiLSTM: exactly zero gradients {live_check['zero_grad']}")
    state, live_launches, moved, _ = _train(card, cfg, live, "live BiLSTM", clips, starts)
    if moved != names:
        raise AssertionError(f"live BiLSTM: parameters that did not move {sorted(names - moved)}")
    log("training", f"live BiLSTM: every one of {len(names)} parameter tensors moved")

    # The trained weights, exported in the JAX package's format, serve a request.
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trained.npz"
        export_params_npz(path, state.model)
        runner = make_cnn_runner(cfg, path, device=DEVICE)
        audio = speech_like_batch(np.random.default_rng(1), B)
        before_serve = bilstm_recurrence.launches
        restored = runner(audio, np.full(B, GAP_START), np.full(B, GAP_LEN))
        torch.cuda.synchronize()
    if bilstm_recurrence.launches - before_serve != 3:
        raise AssertionError("the exported weights' request did not launch lstm_fwd 3 times")
    if tuple(restored.shape) != (B, cfg.data.max_samples) or not torch.isfinite(restored).all():
        raise AssertionError("the exported weights' request is not finite or shaped")
    log("training", f"exported {path.name} (f16 npz, flax keys) served a request of {B} "
                    f"clips: finite, shape {tuple(restored.shape)}")
    return {k: launches[k] + live_launches[k] for k in launches}


def main() -> int:
    smi = phase_device()
    card = f"{torch.cuda.get_device_name(0)}, power limit {smi.split(',')[-1].strip()}"
    ptxas = phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = [phase_kernel(card, ptxas), *phase_kernel_bwd(card, ptxas)]
    serving = phase_serving(card)
    training = phase_training(card)
    for k in kernels:
        k["launches"] = serving[k["name"]] + training[k["name"]]
        k["launches_by_path"] = {"serving": serving[k["name"]], "training": training[k["name"]]}
        if not k["launches"]:
            raise AssertionError(f"{k['name']} was never launched on the main paths")
    log("done", f"total {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
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

"""Forward LSTM recurrence: the CUDA kernel ``csrc/lstm_fwd.cu`` and its
plain PyTorch version.

The kernel replaces the Pallas TPU kernel
``ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py::_fwd_kernel`` (through
``lstm_recurrence_pallas``): given pre-projected inputs ``xw = x @ W_ih + b``
of shape ``(B, T, 4H)`` and ``W_hh (H, 4H)``, it runs the recurrence from
``h = c = 0`` in gate order (i, f, g, o) and returns ``h (B, T, H)`` in
input time order, walking time backwards for the reverse direction.
:func:`bilstm_recurrence` runs both directions of a BiLSTM layer in one
launch, side by side, into one ``(B, T, 2H)`` output; its plain version is
:func:`lstm_recurrence_reference` once per direction.

It is bound by latency, not by bytes or FLOPs: at serving shapes (B=32,
T=417, H=128) a direction reads 27.3 MB of ``xw``, writes 6.8 MB of ``h`` and
does 1.75 GFLOP, but its 417 steps each wait on the last.  So the time loop
runs inside one launch per layer, the carries stay on chip and ``W_hh`` is
read from L2 (see the note in the source).

Build route: one ``nvcc`` call compiles the source, which has a plain C
launcher and no PyTorch headers, into a shared library under
``ml_audio_inpainting_torch/_build/``; ``ctypes`` loads it.  That happens at
the first launch on a CUDA tensor, never at import.

The wrapper takes the plain version for CPU tensors only; on CUDA tensors it
launches the kernel or raises, and counts its launches in
``bilstm_recurrence.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

__all__ = [
    "NVCC_FLAGS",
    "KernelLibrary",
    "load_library",
    "lstm_recurrence_reference",
    "bilstm_recurrence",
    "bilstm_recurrence_reference",
]

_PACKAGE = Path(__file__).resolve().parents[2]
SOURCE = _PACKAGE / "csrc" / "lstm_fwd.cu"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
MAX_HIDDEN = 128  # one thread per gate column: 4H <= 512 threads a block (kMaxThreads)


@dataclass(frozen=True)
class KernelLibrary:
    """The loaded shared library and what building it took."""

    cdll: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date library was found
    compiler_output: str  # nvcc's stdout + stderr (ptxas' -v report)


def _find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin, $CUDA_PATH/bin and "
        "/usr/local/cuda/bin): the LSTM kernel cannot be built"
    )


@functools.cache
def load_library() -> KernelLibrary:
    """Build ``csrc/lstm_fwd.cu`` with one ``nvcc`` call (unless a library of
    the same source and flags is already built) and load it.

    Raises ``RuntimeError`` with the compiler's output if the build fails.
    """
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = BUILD_DIR / f"liblstm_fwd_{digest[:16]}.so"
    seconds, output = 0.0, ""
    if not lib_path.exists():
        nvcc = _find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        output = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{output}"
            )
        os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file
    cdll = ctypes.CDLL(str(lib_path))
    fn = cdll.lstm_fwd_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # xw_fwd, w_hh_fwd
        ctypes.c_void_p, ctypes.c_void_p,  # xw_bwd, w_hh_bwd
        ctypes.c_void_p,  # h_out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, T, H
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return KernelLibrary(cdll, lib_path, seconds, output)


def lstm_recurrence_reference(
    xw: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False
) -> torch.Tensor:
    """Plain PyTorch version of one direction of the kernel, ``(B, T, 4H)`` ->
    ``(B, T, H)``: a Python loop over time with the same math
    (``ml_audio_inpainting_tpu/ops/lstm.py::lstm_scan`` from a zero state)."""
    B, T, _ = xw.shape
    H = w_hh.shape[0]
    h = xw.new_zeros((B, H))
    c = xw.new_zeros((B, H))
    out = xw.new_empty((B, T, H))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xw[:, t] + h @ w_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, t] = h
    return out


def bilstm_recurrence_reference(
    xw_fwd: torch.Tensor, w_hh_fwd: torch.Tensor, xw_bwd: torch.Tensor, w_hh_bwd: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`bilstm_recurrence`: the two directions one
    after the other, concatenated."""
    return torch.cat(
        [
            lstm_recurrence_reference(xw_fwd, w_hh_fwd, reverse=False),
            lstm_recurrence_reference(xw_bwd, w_hh_bwd, reverse=True),
        ],
        dim=-1,
    )


def _check_kernel_args(xw: torch.Tensor, w_hh: torch.Tensor) -> None:
    if xw.device.type != "cuda" or w_hh.device != xw.device:
        raise ValueError(
            f"LSTM kernel: xw on {xw.device} and w_hh on {w_hh.device}; the kernel "
            "needs them on one CUDA device (CPU tensors take the plain version)"
        )
    if xw.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise TypeError(f"LSTM kernel takes float32, got {xw.dtype}/{w_hh.dtype}")
    H = w_hh.shape[0] if w_hh.dim() == 2 else -1
    if xw.dim() != 3 or w_hh.dim() != 2 or w_hh.shape[1] != 4 * H or xw.shape[2] != 4 * H:
        raise ValueError(
            f"expected xw (B, T, 4H) and w_hh (H, 4H), got {tuple(xw.shape)}/{tuple(w_hh.shape)}"
        )
    if not (1 <= H <= MAX_HIDDEN and H % 4 == 0):
        raise ValueError(f"hidden size {H}: the kernel takes multiples of 4 up to {MAX_HIDDEN}")
    if not (xw.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError("LSTM kernel takes contiguous xw and w_hh")


def bilstm_recurrence(
    xw_fwd: torch.Tensor, w_hh_fwd: torch.Tensor, xw_bwd: torch.Tensor, w_hh_bwd: torch.Tensor
) -> torch.Tensor:
    """Both directions of a BiLSTM layer -> ``(B, T, 2H)``: the forward
    direction's ``h`` in ``[..., :H]``, the backward (reverse) one's in
    ``[..., H:]``, both in input time order.

    CPU tensors take :func:`bilstm_recurrence_reference`; CUDA tensors launch
    the kernel once for both directions on the current stream, or raise.
    """
    tensors = (xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd)
    if all(t.device.type == "cpu" for t in tensors):
        return bilstm_recurrence_reference(*tensors)
    _check_kernel_args(xw_fwd, w_hh_fwd)
    _check_kernel_args(xw_bwd, w_hh_bwd)
    if (xw_bwd.shape, w_hh_bwd.shape, xw_bwd.device) != (xw_fwd.shape, w_hh_fwd.shape, xw_fwd.device):
        raise ValueError("bilstm_recurrence: the two directions differ in shape or device")
    B, T, _ = xw_fwd.shape
    H = w_hh_fwd.shape[0]
    h = torch.empty((B, T, 2 * H), device=xw_fwd.device, dtype=xw_fwd.dtype)
    if B == 0 or T == 0:
        return h
    launch = load_library().cdll.lstm_fwd_launch
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = launch(*(t.data_ptr() for t in (*tensors, h)), B, T, H, stream)
    if rc != 0:
        raise RuntimeError(f"lstm_fwd launch failed with CUDA error {rc} (B={B}, T={T}, H={H})")
    bilstm_recurrence.launches += 1
    return h


bilstm_recurrence.launches = 0

"""LSTM recurrence, forward and backward: the CUDA kernels ``csrc/lstm_fwd.cu``
and ``csrc/lstm_bwd.cu``, their plain PyTorch versions, and the
``torch.autograd.Function`` over them.

The kernels replace the Pallas TPU kernels of
``ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py``:

* ``lstm_fwd`` replaces ``_fwd_kernel``: given pre-projected inputs
  ``xw = x @ W_ih + b`` of shape ``(B, T, 4H)`` and ``W_hh (H, 4H)``, it runs
  the recurrence from ``h = c = 0`` in gate order (i, f, g, o) and returns
  ``h (B, T, H)`` in input time order, walking time backwards for the reverse
  direction; for training it also writes the cell states ``c``.
* ``lstm_bwd`` replaces ``_bwd_kernel``: the reverse-time sweep that
  recomputes the gates and writes ``dxw``; ``lstm_dwhh``, in the same source,
  then reduces ``dW_hh = sum_{b,t} h_prev^T dxw`` over the batch, which on
  Hopper is spread over blocks.

Each kernel runs both directions of a BiLSTM layer in one launch, side by
side, on the concatenated ``(B, T, 2H)`` layout of the layer's output.
:func:`bilstm_recurrence` is the entry point: a ``torch.autograd.Function``
(the counterpart of the ``custom_vjp`` at ``lstm_cell.py:202-238``) whose
forward launches ``lstm_fwd`` and whose backward launches ``lstm_bwd`` and
``lstm_dwhh``.  No CUDA path produces a BiLSTM output outside it, so a
CUDA output always carries its gradient.

The sweeps are bound by latency, not by bytes or FLOPs: a sweep has T
dependent steps (417 at the production shapes), each of which needs the
last step's ``h`` (forward) or ``dh`` (backward) from every hidden unit.  So
the time loop runs inside one launch per layer and the carries stay on
chip.  ``lstm_fwd`` and ``lstm_bwd`` each spread ``W_hh`` over the CTAs of a
thread-block cluster, which keep it on chip for the whole sweep (see the
notes in the sources).  The launch plans,
:func:`fwd_plan`, :func:`bwd_plan` and :func:`dwhh_plan`, are computed here
and passed to the launchers, which refuse a plan they cannot run.

Build route: one ``nvcc`` call a source compiles it, with its plain C
launchers and no PyTorch headers, into a shared library under
``ml_audio_inpainting_torch/_build/``; ``ctypes`` loads it.  That happens at
the first launch on a CUDA tensor, never at import.

Each kernel has a wrapper that takes its plain version for CPU tensors only;
on CUDA tensors it launches the kernel or raises.  Launches are counted on
the program's counters (``runtime/profiling.py::count``) under the
kernel's name, ``lstm_fwd`` (launched by :func:`bilstm_forward`),
``lstm_bwd`` and ``lstm_dwhh``, with ``_bf16`` after it for the bf16 forms;
:func:`kernel_launches` reads them.

Element types: f32 and bf16, one type for a layer's ``xw`` and ``W_hh``
(and so for ``h``, ``c``, the incoming gradient and ``dxw``).  bf16 runs as
the Pallas kernels run it (the JAX package's bf16 training): f32 carries,
``W_hh`` and ``xw`` upcast, ``h`` and ``c`` rounded to bf16 only where they
are stored; the backward recomputes the gates from the stored bf16
``h_prev`` and ``c``, stores ``dxw`` in bf16, and sums ``dW_hh`` in f32,
rounded to bf16 once at the end.  Every bf16 form has kernels of its own,
on the tensor cores, whose bf16 operands take each f32 carry as bf16
pieces: the forward's gate product takes the f32 ``h`` as ``FWD_PIECES``
pieces, the backward's dh carry the f32 ``dgates`` as ``DH_PIECES``, and
``dW_hh`` sums the pair ``(dxw, lo)``, ``lo = bf16(dgates - dxw)``, which
carries ``dgates`` to 16 bits (the plain versions compute the same;
:func:`split_bf16`, :func:`bf16_residual`).  A CUDA tensor of any other
type, or of mixed types, raises.
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
from typing import Optional, Tuple

import torch

from ml_audio_inpainting_torch.runtime import profiling

__all__ = [
    "NVCC_FLAGS",
    "SOURCES",
    "KernelLibrary",
    "load_library",
    "kernel_launches",
    "reset_kernel_launches",
    "lstm_recurrence_reference",
    "lstm_recurrence_backward_reference",
    "dwhh_reference",
    "split_bf16",
    "bf16_residual",
    "ClusterPlan",
    "fwd_plan",
    "fwd_smem_bytes",
    "FwdMmaLayout",
    "fwd_mma_layout",
    "fwd_mma_plan",
    "bwd_plan",
    "MmaLayout",
    "bwd_mma_layout",
    "bwd_mma_plan",
    "DwhhPlan",
    "dwhh_plan",
    "dwhh_mma_plan",
    "KERNEL_DTYPES",
    "bilstm_recurrence",
    "bilstm_recurrence_reference",
    "bilstm_forward",
    "bilstm_recurrence_backward",
    "bilstm_dwhh",
]

_PACKAGE = Path(__file__).resolve().parents[2]
# Every CUDA source of the package, built and loaded by load_library
# (``batchnorm`` serves ``ops/cuda/batchnorm.py``).
SOURCES = {
    "lstm_fwd": _PACKAGE / "csrc" / "lstm_fwd.cu",
    "lstm_bwd": _PACKAGE / "csrc" / "lstm_bwd.cu",
    "batchnorm": _PACKAGE / "csrc" / "batchnorm.cu",
}
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# The largest H the kernels take: lstm_bwd's phase A runs a thread per
# (hidden unit, pair of batch rows), 2H <= 256 threads a CTA, and lstm_fwd
# holds a k-slice of W_hh in FWD_MAX_HIDDEN / ksplit registers a lane.
MAX_HIDDEN = 128

# Constants of csrc/lstm_fwd.cu that its launch plan depends on.
FWD_THREADS = 256  # kThreads: threads a CTA
FWD_MAX_CLUSTER = 8  # kMaxCluster: CTAs a cluster (the portable maximum)
FWD_STAGES = 3  # kStages: xw buffers a CTA
FWD_MAX_HIDDEN = 128  # kMaxHidden: the largest H (a k-slice's W_hh in 128 / ksplit registers)
FWD_ROW_CHOICES = (2, 4, 8)  # the Rows (batch rows a cluster) the launcher instantiates
# CTAs that fwd_plan aims the grid at: two on each of an H100's 132 SMs.
FWD_TARGET_CTAS = 256

# Constants of the bf16 form of csrc/lstm_fwd.cu, whose gate product runs on
# the tensor cores (lstm_fwd_mma_kernel).
FWD_PIECES = 3  # kPieces: bf16 pieces of the f32 h in the gate product
FWD_SLOT_WORDS = 4  # kSlotWords: 32-bit words of an h slot (the pieces, padded to 16 bytes)
FWD_MMA_MAX_TILES = 8  # kMmaMaxTiles: k-tiles of the padded inputs at most
FWD_MMA_ROWS = 8  # the Rows instance: batch rows a cluster, one n8 tile
FWD_MMA_PAIR_WARPS = 2  # kPairWarps: warps of a tile pair, each half its k-tiles and one row

# Constants of csrc/lstm_bwd.cu that the launch plans depend on.
BWD_ROWS = 4  # kRows: batch rows a cluster of the sweep
BWD_THREADS = 256  # kThreads: threads a CTA of the sweep and of the reduction
DWHH_TILE = 64  # kTile: dW_hh tile edge of the reduction
DWHH_DEPTH = 32  # kDepth: rows of K a stage of the reduction
# Blocks the reduction aims at (K is cut into as many slices as that takes):
# about two on each of an H100's 132 SMs.
DWHH_TARGET_BLOCKS = 256
# Most rows of K a slice sums in one sequential f32 chain: at B=128 (K =
# 53 376) 8 slices of 6688 rows put dW_hh 8.7e-5 of its largest entry from
# cuBLAS's product, near the 1e-4 bound; chains of at most 1344 rows keep
# the error where B=25's 8 slices of 1312 rows have it (1.8e-5).
DWHH_MAX_SLICE_ROWS = 1344

# Constants of the bf16 forms of csrc/lstm_bwd.cu, whose products run on the
# tensor cores (lstm_bwd_mma_kernel, lstm_dwhh_mma_kernel).
DH_PIECES = 3  # kPieces: bf16 pieces of the f32 dgates in the sweep's dh product
BWD_MMA_ROW_CHOICES = (8, 16)  # the Rows instances: batch rows a cluster, one or two n8 tiles
BWD_MMA_TILE_CHOICES = (4, 8)  # the Tiles instances: A fragments a warp keeps of each product
BWD_MMA_WARPS = 8  # kThreads / 32
BWD_MMA_MAX_UNITS = 32  # kMaxUnits: H / cluster at most (H <= 128, cluster >= 4)
# CTAs that bwd_mma_plan aims the grid at: one wave at one CTA on each of an
# H100's 132 SMs.
BWD_MMA_TARGET_CTAS = 132
DWHH_MMA_TILE = 128  # kDwTile: dW_hh tile edge of the bf16 sum (all of H <= 128)
DWHH_MMA_DEPTH = 32  # kDwDepth: rows of K a stage
DWHH_MMA_STAGES = 3  # kDwStages: cp.async stages of (h_prev, dxw, lo) tiles
# Blocks the bf16 sum aims at: two on each of 132 SMs (each holds its
# stages in 78 KB of shared memory).
DWHH_MMA_TARGET_BLOCKS = 264

# The element types the kernels take, each by kernels and launchers of its own.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C launchers of each source: name -> argument types (the LSTM's: pointers,
# then B, T, H, stream).
_LAUNCHERS = {
    "lstm_fwd": {
        # f32: xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_out, c_out (or null);
        # B, T, H, rows, cluster, ksplit, groups
        "lstm_fwd_launch": [_P] * 6 + [_I] * 7 + [_P],
        # H, rows, cluster, ksplit -> dynamic shared memory of an f32 CTA, bytes
        "lstm_fwd_smem_bytes": [_I] * 4,
        # bf16: the f32 launcher's pointers; B, T, H, rows, cluster, groups
        "lstm_fwd_mma_launch": [_P] * 6 + [_I] * 6 + [_P],
        # H, rows, cluster -> dynamic shared memory of a bf16 CTA, bytes
        "lstm_fwd_mma_smem_bytes": [_I] * 3,
        # H, rows, cluster -> cudaOccupancyMaxActiveClusters (or -error)
        "lstm_fwd_mma_max_clusters": [_I] * 3,
    },
    "lstm_bwd": {
        # f32: xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_seq, c_seq, g_out, dxw_fwd, dxw_bwd;
        # B, T, H, cluster, ksplit
        "lstm_bwd_launch": [_P] * 9 + [_I] * 5 + [_P],
        # f32: h_seq, dxw_fwd, dxw_bwd, part, dw_fwd, dw_bwd; B, T, H, slices, rows_per_slice
        "lstm_dwhh_launch": [_P] * 6 + [_I] * 5 + [_P],
        # H, cluster, ksplit -> dynamic shared memory of an f32 sweep CTA, bytes
        "lstm_bwd_smem_bytes": [_I] * 3,
        # bf16: the f32 sweep's pointers, then lo_fwd, lo_bwd; B, T, H, rows, cluster, ksplit
        "lstm_bwd_mma_launch": [_P] * 11 + [_I] * 6 + [_P],
        # H, rows, cluster, ksplit -> dynamic shared memory of a bf16 sweep CTA, bytes
        "lstm_bwd_mma_smem_bytes": [_I] * 4,
        # H, rows, cluster, ksplit -> cudaOccupancyMaxActiveClusters (or -error)
        "lstm_bwd_mma_max_clusters": [_I] * 4,
        # bf16: h_seq, dxw_fwd, dxw_bwd, lo_fwd, lo_bwd, part, dw_fwd, dw_bwd;
        # B, T, H, slices, rows_per_slice
        "lstm_dwhh_mma_launch": [_P] * 8 + [_I] * 5 + [_P],
    },
    "batchnorm": {
        # x, partial, sums, counter; bf16, B, C, P, chunks, chunk
        "bn_fwd_stats_launch": [_P] * 4 + [_I] * 6 + [_P],
        # x, y, sums, gamma, beta; param_bf16; saved, run_mean, run_var, batches; update;
        # count, eps, keep, take; act; slope; bf16, B, C, P, chunks, chunk
        "bn_fwd_apply_launch": [_P] * 5 + [_I] + [_P] * 4 + [_I] + [_F] * 4 + [_I] + [_F]
                               + [_I] * 6 + [_P],
        # x, dy, saved, gamma, beta; param_bf16; partial, sums, counter, dgamma, dbeta;
        # eps; act; slope; bf16, B, C, P, chunks, chunk
        "bn_bwd_reduce_launch": [_P] * 5 + [_I] + [_P] * 5 + [_F] + [_I] + [_F] + [_I] * 6
                                + [_P],
        # x, dy, saved, sums, gamma, beta; param_bf16; dx; count, eps; act; slope;
        # bf16, B, C, P, chunks, chunk
        "bn_bwd_apply_launch": [_P] * 6 + [_I] + [_P] + [_F] * 2 + [_I] + [_F] + [_I] * 6
                               + [_P],
    },
}


@dataclass(frozen=True)
class KernelLibrary:
    """A loaded shared library and what building it took."""

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
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


@functools.cache
def load_library(name: str) -> KernelLibrary:
    """Build ``SOURCES[name]`` with one ``nvcc`` call (unless a library of the
    same source and flags is already built) and load it.  Distinct sources
    may be built concurrently from threads.

    Raises ``RuntimeError`` with the compiler's output if the build fails.
    """
    source = SOURCES[name]
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    seconds, output = 0.0, ""
    if not lib_path.exists():
        nvcc = _find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)]
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
    for fn_name, argtypes in _LAUNCHERS[name].items():
        fn = getattr(cdll, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(cdll, lib_path, seconds, output)


# ---------------------------------------------------------------- plain versions


def _carry_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the recurrences carry and compute in: f32 for bf16 inputs
    (the Pallas kernels' f32 scratch and ``preferred_element_type``), the
    inputs' own type for f32 and f64."""
    return torch.promote_types(dtype, torch.float32)


def lstm_recurrence_reference(
    xw: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False, return_c: bool = False,
    pieces: int = FWD_PIECES,
):
    """Plain PyTorch version of one direction of ``lstm_fwd``, ``(B, T, 4H)``
    -> ``h (B, T, H)`` (and ``c (B, T, H)`` too with ``return_c``): a Python
    loop over time with the same math
    (``ml_audio_inpainting_tpu/ops/lstm.py::lstm_scan`` from a zero state).

    bf16 inputs run as ``_fwd_kernel`` runs them: ``xw`` and ``W_hh``
    upcast, ``h`` and ``c`` carried in f32 and rounded to bf16 only where
    they are stored.  The product ``h @ W_hh`` takes the f32 ``h`` as the
    sum of ``pieces`` bf16 pieces (:func:`split_bf16`), each an exact bf16
    operand of the tensor cores, as the bf16 kernel does: one piece (``h``
    rounded) moves ``h`` and ``c`` off Pallas's f32 product, three keep
    them as close (``tests/test_torch_bf16_lstm.py``)."""
    B, T, _ = xw.shape
    H = w_hh.shape[0]
    acc = _carry_dtype(xw.dtype)
    split = acc != xw.dtype  # bf16: the product reads h as bf16 pieces
    w_hh = w_hh.to(acc)
    h = xw.new_zeros((B, H), dtype=acc)
    c = xw.new_zeros((B, H), dtype=acc)
    h_seq = xw.new_empty((B, T, H))
    c_seq = xw.new_empty((B, T, H)) if return_c else None
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xw[:, t].to(acc) + (_split_product(h, w_hh, pieces) if split else h @ w_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        h_seq[:, t] = h
        if return_c:
            c_seq[:, t] = c
    return (h_seq, c_seq) if return_c else h_seq


def bilstm_recurrence_reference(
    xw_fwd: torch.Tensor,
    w_hh_fwd: torch.Tensor,
    xw_bwd: torch.Tensor,
    w_hh_bwd: torch.Tensor,
    return_c: bool = False,
):
    """Plain version of ``lstm_fwd``: the two directions one after the other,
    concatenated to ``(B, T, 2H)`` (``h``, or ``(h, c)`` with ``return_c``)."""
    fwd = lstm_recurrence_reference(xw_fwd, w_hh_fwd, reverse=False, return_c=return_c)
    bwd = lstm_recurrence_reference(xw_bwd, w_hh_bwd, reverse=True, return_c=return_c)
    if not return_c:
        return torch.cat([fwd, bwd], dim=-1)
    return torch.cat([fwd[0], bwd[0]], dim=-1), torch.cat([fwd[1], bwd[1]], dim=-1)


def _shift_prev(seq: torch.Tensor, reverse: bool) -> torch.Tensor:
    """``seq`` at each step's forward predecessor, zero where there is none:
    ``seq[:, t-1]`` (forward) or ``seq[:, t+1]`` (reverse)."""
    zero = seq.new_zeros(seq[:, :1].shape)
    if reverse:
        return torch.cat([seq[:, 1:], zero], dim=1)
    return torch.cat([zero, seq[:, :-1]], dim=1)


def lstm_recurrence_backward_reference(
    xw: torch.Tensor,
    w_hh: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    g: torch.Tensor,
    reverse: bool = False,
    return_dgates: bool = False,
    pieces: int = DH_PIECES,
):
    """Plain version of one direction of ``lstm_bwd``: ``dxw (B, T, 4H)``, the
    gradient of ``sum(h * g)`` for the direction's saved ``h``, ``c`` and
    incoming ``g``, all ``(B, T, H)``.  A Python loop over time with
    ``_bwd_kernel``'s math, sweeping against the forward recurrence's order;
    :func:`dwhh_reference` of its unrounded ``dgates`` is ``_bwd_kernel``'s
    ``dW_hh``.

    bf16 inputs run as the bf16 kernel runs them: the gates recomputed from
    the stored (bf16) ``h_prev`` and ``c`` and the upcast ``xw`` and
    ``W_hh`` (exact products summed in f32, as ``_bwd_kernel`` and the
    tensor cores sum them), the ``dh`` and ``dc`` carries in f32, and
    ``dgates`` rounded to bf16 only where it is stored as ``dxw``.  The
    carry ``dh = dgates @ W_hh^T`` takes the f32 ``dgates`` as the sum of
    ``pieces`` bf16 pieces (:func:`split_bf16`), each an exact bf16 operand
    of the tensor cores: one piece (``dgates`` rounded) moves ``dxw`` off
    Pallas's f32 product, three put it as close as an f32 product
    (``tests/test_torch_bf16_lstm.py``).  With ``return_dgates`` the result
    is ``(dxw, dgates)``, ``dgates`` unrounded (for f32 inputs the same
    values as ``dxw``); :func:`bf16_residual` of the two is the kernel's
    ``lo``."""
    B, T, _ = xw.shape
    H = w_hh.shape[0]
    acc = _carry_dtype(xw.dtype)
    xw_in, w_hh = xw, w_hh.to(acc)
    xw, h, c, g = (t.to(acc) for t in (xw, h, c, g))
    h_prev = _shift_prev(h, reverse)
    c_prev = _shift_prev(c, reverse)
    dh_carry = xw.new_zeros((B, H))
    dc_carry = xw.new_zeros((B, H))
    dxw = xw_in.new_empty(xw.shape)
    split = acc != xw_in.dtype  # bf16: the dh carry reads dgates as bf16 pieces
    dg_seq = xw.new_empty(xw.shape) if return_dgates and split else None
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        gates = xw[:, t] + h_prev[:, t] @ w_hh
        i, f, gg, o = gates.chunk(4, dim=-1)
        i, f, gg, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), torch.sigmoid(o)
        dh = dh_carry + g[:, t]
        tc = torch.tanh(c[:, t])
        dc = dc_carry + dh * o * (1.0 - tc * tc)
        dgates = torch.cat(
            [
                dc * gg * i * (1.0 - i),
                dc * c_prev[:, t] * f * (1.0 - f),
                dc * i * (1.0 - gg * gg),
                dh * tc * o * (1.0 - o),
            ],
            dim=-1,
        )
        dxw[:, t] = dgates
        if dg_seq is not None:
            dg_seq[:, t] = dgates
        dh_carry = _split_product(dgates, w_hh.T, pieces) if split else dgates @ w_hh.T
        dc_carry = dc * f
    if return_dgates:
        return dxw, (dxw if dg_seq is None else dg_seq)
    return dxw


def split_bf16(x: torch.Tensor, pieces: int) -> list:
    """``x`` (f32) as ``pieces`` bf16 tensors whose sum approaches it: each
    piece is the residual left by the earlier ones, rounded to nearest even
    (the first is ``x`` rounded, the second :func:`bf16_residual`).  Three
    pieces carry 24 bits of ``x``, all that f32 has, wherever no piece
    falls below bf16's range."""
    out, rest = [], x
    for _ in range(pieces):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].to(rest.dtype)
    return out


def bf16_residual(dgates: torch.Tensor, dxw: torch.Tensor) -> torch.Tensor:
    """``lo = bf16(dgates - dxw)``: what the bf16 ``dxw`` (``dgates``
    rounded) leaves of the f32 ``dgates``, in bf16.  ``dxw + lo`` carries
    16 bits of ``dgates``, enough for ``dW_hh`` (:func:`dwhh_reference`)."""
    return (dgates - dxw.to(dgates.dtype)).to(torch.bfloat16)


def _split_product(x: torch.Tensor, w: torch.Tensor, pieces: int) -> torch.Tensor:
    """``x @ w`` in f32 with ``x`` taken as :func:`split_bf16` pieces, one
    product each, summed from the smallest piece's up, as the bf16 kernel
    sums its accumulators (``w``: bf16 values, upcast)."""
    parts = [p.to(w.dtype) @ w for p in split_bf16(x, pieces)]
    total = parts[-1]
    for part in reversed(parts[:-1]):
        total = total + part
    return total


def dwhh_reference(h: torch.Tensor, dgates: torch.Tensor, reverse: bool = False,
                   lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of one direction of ``lstm_dwhh``:
    ``sum_{b,t} h_prev[b, t]^T dgates[b, t]`` for the direction's ``h (B, T,
    H)``, in ``h``'s type.  For bf16 ``h`` the sum runs in f32 over the
    upcast ``h`` and ``dgates``, and is rounded once at the end; with ``lo``
    (the bf16 kernel's pair: ``dgates`` is the bf16 ``dxw``, ``lo`` its
    :func:`bf16_residual`) it is ``h_prev^T dxw + h_prev^T lo``, two
    products in f32 added before the one rounding."""
    acc = _carry_dtype(h.dtype)
    h_prev = _shift_prev(h, reverse).to(acc).reshape(-1, h.shape[-1]).T
    dw = h_prev @ dgates.to(acc).reshape(-1, dgates.shape[-1])
    if lo is not None:
        dw = dw + h_prev @ lo.to(acc).reshape(-1, lo.shape[-1])
    return dw.to(h.dtype)


# ---------------------------------------------------------------- launch plans


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class ClusterPlan:
    """How a sweep kernel (``lstm_fwd``, ``lstm_bwd``) lays a layer of hidden
    size ``H`` and batch ``B`` over the card: one cluster of ``cluster`` CTAs
    per ``rows`` batch rows and direction; CTA ``r`` owns ``units`` hidden
    units and their 4 gate columns, and splits its gate product over
    ``ksplit`` slices of the ``H`` inputs."""

    B: int
    H: int
    rows: int
    cluster: int
    units: int
    ksplit: int
    groups: int

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.cluster * self.groups, 2)

    def units_of(self, rank: int) -> range:
        return range(rank * self.units, (rank + 1) * self.units)

    def columns_of(self, rank: int) -> list:
        """Gate columns of CTA ``rank``, in the order of its W_hh slice."""
        return [q * self.H + n for q in range(4) for n in self.units_of(rank)]

    def k_parts(self) -> list:
        """The ``ksplit`` slices ``[begin, end)`` of the inputs of a gate."""
        span = _cdiv(_cdiv(self.H, self.ksplit), 4) * 4
        return [(min(self.H, q * span), min(self.H, (q + 1) * span)) for q in range(self.ksplit)]

    def batch_rows_of(self, group: int) -> range:
        """The batch rows cluster ``group`` runs (of each direction)."""
        return range(group * self.rows, min(self.B, (group + 1) * self.rows))


def fwd_plan(B: int, H: int, rows: Optional[int] = None) -> ClusterPlan:
    """The plan of ``lstm_fwd`` for ``H % 4 == 0``, ``4 <= H <= 128``: a
    cluster of 8 CTAs where 8 divides ``H``, else 4; a gate's product split
    over 4 k-slices, a lane each (2 where 16 lanes a unit would exceed
    ``FWD_THREADS``); clusters of ``rows`` batch rows, one of
    ``FWD_ROW_CHOICES``.  By default the fewest rows that keep the grid
    within ``FWD_TARGET_CTAS`` CTAs, else the most: a step is bound by
    latency, and two clusters on the same SMs hide part of each other's.
    The rows do not change the result, only the time."""
    cluster = FWD_MAX_CLUSTER if H % FWD_MAX_CLUSTER == 0 else 4
    units = H // cluster
    ksplit = 4 if 16 * units <= FWD_THREADS else 2
    if rows is None:
        rows = next((r for r in FWD_ROW_CHOICES
                     if 2 * cluster * _cdiv(B, r) <= FWD_TARGET_CTAS), FWD_ROW_CHOICES[-1])
    if rows not in FWD_ROW_CHOICES:
        raise ValueError(f"lstm_fwd runs {FWD_ROW_CHOICES} batch rows a cluster, not {rows}")
    return ClusterPlan(B, H, rows, cluster, units, ksplit, _cdiv(B, rows))


def fwd_smem_bytes(plan: ClusterPlan) -> int:
    """Dynamic shared memory of an f32 ``lstm_fwd`` CTA under ``plan``, as
    ``FwdLayout`` in ``csrc/lstm_fwd.cu`` lays it out: the W_hh slice (row
    stride padded to an odd multiple of 4), two h buffers (each row's
    k-slices in segments of ``FWD_MAX_HIDDEN / ksplit + 4`` floats) and
    ``FWD_STAGES`` xw buffers, all f32."""
    ldw = 4 * ((plan.units + 1) | 1)
    ncol = 4 * plan.units
    hrow = plan.ksplit * (FWD_MAX_HIDDEN // plan.ksplit + 4)
    floats = plan.H * ldw + 2 * plan.rows * hrow
    return 4 * floats + _cdiv(4 * FWD_STAGES * plan.rows * ncol, 16) * 16


@dataclass(frozen=True)
class FwdMmaLayout:
    """A bf16 forward CTA under a plan, as ``MmaFwdLayout`` in
    ``csrc/lstm_fwd.cu`` computes it: its ``units`` padded to ``upad`` (a
    multiple of 8), ``ugroups`` groups of 8 units (the m side of a tile
    pair, with ``rows / 8`` n-tiles, each pair ``FWD_MMA_PAIR_WARPS``
    warps: ``threads`` threads); the cluster's units in padded order as
    ``ktiles`` 16-wide k-tiles of the gate product; ``step_bytes``, the h
    slots of one parity, which every CTA receives a step; ``smem_bytes`` of
    dynamic shared memory (the slots of both parities, the pairs'
    mailboxes, two mbarriers)."""

    upad: int
    ugroups: int
    ktiles: int
    threads: int
    step_bytes: int
    smem_bytes: int

    def slot_of(self, rank: int, group: int) -> int:
        """The slot (2 x k-tile + half) of the B fragments that unit group
        ``group`` of CTA ``rank`` fills: its units' padded inputs."""
        kp = rank * self.upad + 8 * group
        return (kp // 16) * 2 + (kp // 8) % 2


def fwd_mma_layout(plan: ClusterPlan) -> FwdMmaLayout:
    upad = _cdiv(plan.units, 8) * 8
    ktiles = plan.cluster * upad // 16
    n_tiles = plan.rows // 8
    pairs = (upad // 8) * n_tiles
    step = 4 * FWD_SLOT_WORDS * n_tiles * ktiles * 2 * 32
    smem = 2 * step + 16 * pairs * FWD_MMA_PAIR_WARPS * 32 + 16
    return FwdMmaLayout(upad, upad // 8, ktiles, 32 * pairs * FWD_MMA_PAIR_WARPS, step, smem)


def fwd_mma_plan(B: int, H: int) -> ClusterPlan:
    """The plan of the bf16 forward (``lstm_fwd_mma_kernel``) for ``H % 4 ==
    0``, ``4 <= H <= 128``: clusters of 8 CTAs where 8 divides ``H``, else
    4, as the f32 form, of ``FWD_MMA_ROWS`` batch rows each, at any ``B``
    (the clusters are independent; at B=128, 256 CTAs, one wave).  A tile
    pair's k-tiles are halved between its two warps (``ksplit`` 2)."""
    cluster = 8 if H % 8 == 0 else 4
    return ClusterPlan(B, H, FWD_MMA_ROWS, cluster, H // cluster, FWD_MMA_PAIR_WARPS,
                       _cdiv(B, FWD_MMA_ROWS))


def bwd_plan(B: int, H: int) -> ClusterPlan:
    """The plan of ``lstm_bwd`` for ``H % 4 == 0``, ``4 <= H <= 128``: a
    cluster of 8 CTAs (the portable maximum) where 8 divides ``H``, else 4,
    of ``BWD_ROWS`` batch rows; as many k-slices (multiples of 4 inputs,
    none empty) as ``BWD_THREADS`` threads of (column, slice) pairs can
    take."""
    cluster = 8 if H % 8 == 0 else 4
    units = H // cluster
    most = max(1, min(BWD_THREADS // (4 * units), H // 4))
    span = _cdiv(_cdiv(H, most), 4) * 4
    return ClusterPlan(B, H, BWD_ROWS, cluster, units, _cdiv(H, span), _cdiv(B, BWD_ROWS))


@dataclass(frozen=True)
class MmaLayout:
    """The tiles and shared memory of a bf16 sweep CTA under a plan, as
    ``MmaLayout`` in ``csrc/lstm_bwd.cu`` computes them: ``kh`` 16-wide tiles
    of the H inputs (gate product) and of the H units (dh product), ``kc`` of
    the CTA's ``4u`` gate columns; the gate product's k-tiles in ``ksplit``
    slices of ``span``; ``tiles`` A fragments a warp keeps of either
    product; ``smem_bytes`` of dynamic shared memory."""

    kh: int
    kc: int
    span: int
    tiles: int
    smem_bytes: int


def bwd_mma_layout(plan: ClusterPlan) -> MmaLayout:
    kh, kc = _cdiv(plan.H, 16), _cdiv(4 * plan.units, 16)
    span = _cdiv(kh, plan.ksplit)
    ldh, ldd, ldp, ldg = 16 * kh + 8, 16 * kc + 8, 16 * kh + 4, 16 * kc + 4
    rows = plan.rows
    smem = (2 * 2 * rows * ldh + 2 * DH_PIECES * rows * ldd + 4 * 2 * rows * ldp
            + 4 * 2 * plan.ksplit * rows * ldg)
    return MmaLayout(kh, kc, span, max(span, kc), smem)


def bwd_mma_plan(B: int, H: int) -> ClusterPlan:
    """The plan of the bf16 sweep (``lstm_bwd_mma_kernel``) for ``H % 4 ==
    0``, ``4 <= H <= 128``: clusters of 8 CTAs where 8 divides ``H``, else 4,
    as the f32 sweep; as batch rows a cluster the fewest of
    ``BWD_MMA_ROW_CHOICES`` that keep the grid within ``BWD_MMA_TARGET_CTAS``
    (one wave at one CTA an SM), else the most; the gate product's k-tiles in
    as many slices (a warp each, beside the other column tiles' warps) as
    ``BWD_MMA_WARPS`` warps take, none empty."""
    cluster = 8 if H % 8 == 0 else 4
    units = H // cluster
    rows = next((r for r in BWD_MMA_ROW_CHOICES
                 if 2 * cluster * _cdiv(B, r) <= BWD_MMA_TARGET_CTAS), BWD_MMA_ROW_CHOICES[-1])
    kh, kc = _cdiv(H, 16), _cdiv(4 * units, 16)
    span = _cdiv(kh, max(1, min(BWD_MMA_WARPS // kc, kh)))
    return ClusterPlan(B, H, rows, cluster, units, _cdiv(kh, span), _cdiv(B, rows))


@dataclass(frozen=True)
class DwhhPlan:
    """How ``lstm_dwhh`` splits ``dW_hh = h_prev^T dxw`` of depth ``K = B*T``:
    ``tiles_i x tiles_j`` output tiles of ``DWHH_TILE`` squared per
    direction, times ``slices`` fixed slices of ``rows_per_slice`` rows of
    K, each block writing one partial; a second pass sums the partials in
    slice order."""

    H: int
    K: int
    tiles_i: int
    tiles_j: int
    slices: int
    rows_per_slice: int

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.tiles_i * self.tiles_j, self.slices, 2)

    @property
    def partial_shape(self) -> Tuple[int, int, int, int]:
        return (2, self.slices, self.H, 4 * self.H)

    def rows_of(self, s: int) -> range:
        return range(s * self.rows_per_slice, min(self.K, (s + 1) * self.rows_per_slice))


def dwhh_plan(B: int, T: int, H: int) -> DwhhPlan:
    """Slices enough for about ``DWHH_TARGET_BLOCKS`` blocks and for at most
    ``DWHH_MAX_SLICE_ROWS`` rows a slice, each a whole number of
    ``DWHH_DEPTH``-row stages, none empty."""
    K = B * T
    tiles_i, tiles_j = _cdiv(H, DWHH_TILE), _cdiv(4 * H, DWHH_TILE)
    want = max(1, min(_cdiv(DWHH_TARGET_BLOCKS, 2 * tiles_i * tiles_j), _cdiv(K, DWHH_DEPTH)),
               _cdiv(K, DWHH_MAX_SLICE_ROWS))
    rows = _cdiv(_cdiv(K, want), DWHH_DEPTH) * DWHH_DEPTH
    return DwhhPlan(H, K, tiles_i, tiles_j, _cdiv(K, rows), rows)


def dwhh_mma_plan(B: int, T: int, H: int) -> DwhhPlan:
    """The bf16 sum's split of ``K = B*T`` (``lstm_dwhh_mma_kernel``): tiles
    of ``DWHH_MMA_TILE`` squared (all of ``H``), slices enough for about
    ``DWHH_MMA_TARGET_BLOCKS`` blocks, each a whole number of
    ``DWHH_MMA_DEPTH``-row stages, none empty."""
    K = B * T
    tiles_i, tiles_j = _cdiv(H, DWHH_MMA_TILE), _cdiv(4 * H, DWHH_MMA_TILE)
    want = max(1, min(_cdiv(DWHH_MMA_TARGET_BLOCKS, 2 * tiles_i * tiles_j),
                      _cdiv(K, DWHH_MMA_DEPTH)))
    rows = _cdiv(_cdiv(K, want), DWHH_MMA_DEPTH) * DWHH_MMA_DEPTH
    return DwhhPlan(H, K, tiles_i, tiles_j, _cdiv(K, rows), rows)


# ---------------------------------------------------------------- kernel wrappers


def _check_kernel_args(xw: torch.Tensor, w_hh: torch.Tensor) -> None:
    if xw.device.type != "cuda" or w_hh.device != xw.device:
        raise ValueError(
            f"LSTM kernel: xw on {xw.device} and w_hh on {w_hh.device}; the kernel "
            "needs them on one CUDA device (CPU tensors take the plain version)"
        )
    if xw.dtype not in KERNEL_DTYPES or w_hh.dtype != xw.dtype:
        raise TypeError(f"LSTM kernel takes float32 or bfloat16 xw and w_hh of one type, got "
                        f"{xw.dtype}/{w_hh.dtype}")
    H = w_hh.shape[0] if w_hh.dim() == 2 else -1
    if xw.dim() != 3 or w_hh.dim() != 2 or w_hh.shape[1] != 4 * H or xw.shape[2] != 4 * H:
        raise ValueError(
            f"expected xw (B, T, 4H) and w_hh (H, 4H), got {tuple(xw.shape)}/{tuple(w_hh.shape)}"
        )
    if not (1 <= H <= MAX_HIDDEN and H % 4 == 0):
        raise ValueError(f"hidden size {H}: the kernel takes multiples of 4 up to {MAX_HIDDEN}")
    if not (xw.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError("LSTM kernel takes contiguous xw and w_hh")


def _check_pair(xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd) -> None:
    _check_kernel_args(xw_fwd, w_hh_fwd)
    _check_kernel_args(xw_bwd, w_hh_bwd)
    if (xw_bwd.shape, w_hh_bwd.shape, xw_bwd.device) != (xw_fwd.shape, w_hh_fwd.shape, xw_fwd.device):
        raise ValueError("LSTM kernel: the two directions differ in shape or device")
    if xw_bwd.dtype != xw_fwd.dtype:
        raise TypeError(f"LSTM kernel takes the two directions of one type, got "
                        f"{xw_fwd.dtype}/{xw_bwd.dtype}")


def _check_layer_seq(name: str, t: torch.Tensor, like: torch.Tensor, width: int,
                     dtype: Optional[torch.dtype] = None) -> None:
    """A ``(B, T, width)`` contiguous tensor of ``dtype`` (by default
    ``like``'s) on ``like``'s device."""
    B, T, _ = like.shape
    dtype = like.dtype if dtype is None else dtype
    if t.device != like.device or t.dtype != dtype:
        raise ValueError(f"LSTM kernel: {name} is {t.dtype} on {t.device}, expected "
                         f"{dtype} on {like.device}")
    if tuple(t.shape) != (B, T, width) or not t.is_contiguous():
        raise ValueError(f"LSTM kernel: {name} must be contiguous {(B, T, width)}, "
                         f"got {tuple(t.shape)}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it if its data does not start on 16 bytes (the
    kernels read 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def bilstm_forward(
    xw_fwd: torch.Tensor,
    w_hh_fwd: torch.Tensor,
    xw_bwd: torch.Tensor,
    w_hh_bwd: torch.Tensor,
    with_c: bool = False,
    rows: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(h, c)`` of both directions of a BiLSTM layer, each ``(B, T, 2H)``
    as :func:`bilstm_recurrence` lays out ``h``; ``c`` is None unless
    ``with_c``.  Not differentiable: :func:`bilstm_recurrence` is the entry
    point, and this is its forward.

    CPU tensors take :func:`bilstm_recurrence_reference`; CUDA tensors launch
    ``lstm_fwd`` once for both directions, or raise: in f32
    ``lstm_fwd_kernel`` on the clusters of :func:`fwd_plan`, in bf16
    ``lstm_fwd_mma_kernel`` on those of :func:`fwd_mma_plan` (``rows``, the
    f32 plan's batch rows a cluster, is refused in bf16; the result does not
    depend on it), counted as ``lstm_fwd`` (``lstm_fwd_bf16`` in bf16,
    :func:`kernel_launches`).  ``h`` and ``c`` are in the inputs' type.
    """
    tensors = (xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd)
    if all(t.device.type == "cpu" for t in tensors):
        if with_c:
            return bilstm_recurrence_reference(*tensors, return_c=True)
        return bilstm_recurrence_reference(*tensors), None
    _check_pair(*tensors)
    B, T, _ = xw_fwd.shape
    H = w_hh_fwd.shape[0]
    h = torch.empty((B, T, 2 * H), device=xw_fwd.device, dtype=xw_fwd.dtype)
    c = torch.empty_like(h) if with_c else None
    if B == 0 or T == 0:
        return h, c
    lib = load_library("lstm_fwd").cdll
    xw_f, xw_b = _aligned16(xw_fwd), _aligned16(xw_bwd)
    ptrs = [*(t.data_ptr() for t in (xw_f, w_hh_fwd, xw_b, w_hh_bwd, h)),
            None if c is None else c.data_ptr()]
    with torch.cuda.device(h.device):
        if h.dtype == torch.bfloat16:
            if rows is not None:
                raise ValueError(f"the bf16 lstm_fwd runs {FWD_MMA_ROWS} batch rows a cluster; "
                                 f"rows={rows} is the f32 plan's")
            plan = fwd_mma_plan(B, H)
            rc = lib.lstm_fwd_mma_launch(*ptrs, B, T, H, plan.rows, plan.cluster, plan.groups,
                                         _stream(h.device))
        else:
            plan = fwd_plan(B, H, rows)
            rc = lib.lstm_fwd_launch(*ptrs, B, T, H, plan.rows, plan.cluster, plan.ksplit,
                                     plan.groups, _stream(h.device))
    if rc != 0:
        raise RuntimeError(f"lstm_fwd launch failed with CUDA error {rc} (B={B}, T={T}, H={H}, "
                           f"{h.dtype}, {plan})")
    _count("lstm_fwd", h.dtype)
    return h, c


def bilstm_recurrence_backward(
    xw_fwd: torch.Tensor,
    w_hh_fwd: torch.Tensor,
    xw_bwd: torch.Tensor,
    w_hh_bwd: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    g: torch.Tensor,
    dgates: bool = False,
) -> Tuple[Optional[torch.Tensor], ...]:
    """``(dxw_fwd, dxw_bwd)``, the gradients of ``sum(h * g)`` with respect to
    a BiLSTM layer's projected inputs, in their type, given its forward
    inputs, its ``(B, T, 2H)`` outputs ``h`` and ``c``
    (:func:`bilstm_forward`) and the incoming gradient ``g``.  With
    ``dgates``, ``(dxw_fwd, dxw_bwd, lo_fwd, lo_bwd)``: in bf16 ``lo`` is
    the bf16 residual of the f32 dgates that ``dxw`` rounds
    (:func:`bf16_residual`), and ``(dxw, lo)`` is what :func:`bilstm_dwhh`
    sums into ``dW_hh``; in f32 ``dxw`` is the dgates and ``lo`` is None.

    CPU tensors take :func:`lstm_recurrence_backward_reference` per
    direction; CUDA tensors launch ``lstm_bwd`` once for both directions,
    or raise: in f32 ``lstm_bwd_kernel`` on the clusters of
    :func:`bwd_plan`, in bf16 ``lstm_bwd_mma_kernel`` on those of
    :func:`bwd_mma_plan`, which also writes ``lo`` into buffers allocated
    here, whether or not they are returned.
    """
    tensors = (xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h, c, g)
    if all(t.device.type == "cpu" for t in tensors):
        H = w_hh_fwd.shape[0]
        out = []
        for xw, w, sl, reverse in ((xw_fwd, w_hh_fwd, slice(0, H), False),
                                   (xw_bwd, w_hh_bwd, slice(H, 2 * H), True)):
            dxw, dg = lstm_recurrence_backward_reference(
                xw, w, h[..., sl], c[..., sl], g[..., sl], reverse=reverse, return_dgates=True)
            out.append((dxw, bf16_residual(dg, dxw) if xw.dtype == torch.bfloat16 else None))
        (dxw_f, lo_f), (dxw_b, lo_b) = out
        return (dxw_f, dxw_b, lo_f, lo_b) if dgates else (dxw_f, dxw_b)
    _check_pair(xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd)
    B, T, _ = xw_fwd.shape
    H = w_hh_fwd.shape[0]
    for name, t in (("h", h), ("c", c), ("g", g)):
        _check_layer_seq(name, t, xw_fwd, 2 * H)
    dxw_f = torch.empty_like(xw_fwd)
    dxw_b = torch.empty_like(xw_bwd)
    bf16 = xw_fwd.dtype == torch.bfloat16
    lo_f, lo_b = (torch.empty_like(dxw_f), torch.empty_like(dxw_b)) if bf16 else (None, None)
    out = (dxw_f, dxw_b, lo_f, lo_b) if dgates else (dxw_f, dxw_b)
    if B == 0 or T == 0:
        return out
    lib = load_library("lstm_bwd").cdll
    inputs = [_aligned16(t) for t in tensors]
    ptrs = [t.data_ptr() for t in (*inputs, dxw_f, dxw_b)]
    with torch.cuda.device(h.device):
        if bf16:
            plan = bwd_mma_plan(B, H)
            rc = lib.lstm_bwd_mma_launch(*ptrs, lo_f.data_ptr(), lo_b.data_ptr(), B, T, H,
                                         plan.rows, plan.cluster, plan.ksplit, _stream(h.device))
        else:
            plan = bwd_plan(B, H)
            rc = lib.lstm_bwd_launch(*ptrs, B, T, H, plan.cluster, plan.ksplit, _stream(h.device))
    if rc != 0:
        raise RuntimeError(f"lstm_bwd launch failed with CUDA error {rc} (B={B}, T={T}, H={H}, "
                           f"{xw_fwd.dtype}, {plan})")
    _count("lstm_bwd", xw_fwd.dtype)
    return out


def bilstm_dwhh(
    h: torch.Tensor,
    dxw_fwd: torch.Tensor,
    dxw_bwd: torch.Tensor,
    lo_fwd: Optional[torch.Tensor] = None,
    lo_bwd: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dW_hh_fwd, dW_hh_bwd)`` in ``h``'s type, each
    ``sum_{b,t} h_prev[b, t]^T dgates[b, t]`` for its half of ``h (B, T,
    2H)``: in f32 the dgates are ``dxw``; in bf16 they are the pair ``(dxw,
    lo)`` of :func:`bilstm_recurrence_backward`, summed as ``h_prev^T dxw +
    h_prev^T lo`` in f32 and rounded once.

    CPU tensors take :func:`dwhh_reference`; CUDA tensors launch
    ``lstm_dwhh`` once for both directions (its f32 partial products over
    the fixed slices of K of :func:`dwhh_plan`, f32, or
    :func:`dwhh_mma_plan`, bf16 on the tensor cores, then their sum in slice
    order, so the result does not change from run to run, rounded to ``h``'s
    type at the end), or raise.
    """
    H = h.shape[-1] // 2
    if all(t.device.type == "cpu" for t in (h, dxw_fwd, dxw_bwd, lo_fwd, lo_bwd)
           if t is not None):
        return (dwhh_reference(h[..., :H], dxw_fwd, reverse=False, lo=lo_fwd),
                dwhh_reference(h[..., H:], dxw_bwd, reverse=True, lo=lo_bwd))
    if h.device.type != "cuda":
        raise ValueError(f"lstm_dwhh: h on {h.device}; the kernel needs CUDA tensors")
    if h.dtype not in KERNEL_DTYPES:
        raise TypeError(f"lstm_dwhh takes float32 or bfloat16 h, got {h.dtype}")
    bf16 = h.dtype == torch.bfloat16
    if bf16 != (lo_fwd is not None) or bf16 != (lo_bwd is not None):
        raise ValueError("lstm_dwhh sums (dxw, lo) pairs for bf16 h and dxw alone for f32 h")
    seqs = (("dxw_fwd", dxw_fwd), ("dxw_bwd", dxw_bwd), ("lo_fwd", lo_fwd), ("lo_bwd", lo_bwd))
    seqs = seqs if bf16 else seqs[:2]
    for name, t in seqs:
        _check_layer_seq(name, t, h, 4 * H)
    _check_layer_seq("h", h, h, 2 * H)
    B, T, _ = h.shape
    dw_f = torch.empty((H, 4 * H), device=h.device, dtype=h.dtype)
    dw_b = torch.empty_like(dw_f)
    if B == 0 or T == 0:
        return dw_f.zero_(), dw_b.zero_()
    plan = dwhh_mma_plan(B, T, H) if bf16 else dwhh_plan(B, T, H)
    part = torch.empty(plan.partial_shape, device=h.device, dtype=torch.float32)
    lib = load_library("lstm_bwd").cdll
    inputs = [_aligned16(t) for t in (h, *(t for _, t in seqs))]
    launch = lib.lstm_dwhh_mma_launch if bf16 else lib.lstm_dwhh_launch
    with torch.cuda.device(h.device):
        rc = launch(*(t.data_ptr() for t in (*inputs, part, dw_f, dw_b)), B, T, H, plan.slices,
                    plan.rows_per_slice, _stream(h.device))
    if rc != 0:
        raise RuntimeError(f"lstm_dwhh launch failed with CUDA error {rc} (B={B}, T={T}, H={H}, "
                           f"{h.dtype}, {plan})")
    _count("lstm_dwhh", h.dtype)
    return dw_f, dw_b


class _BiLSTMRecurrence(torch.autograd.Function):
    """``lstm_fwd`` forward, ``lstm_bwd`` + ``lstm_dwhh`` backward (the
    ``custom_vjp`` of ``lstm_recurrence_pallas``, for both directions)."""

    @staticmethod
    def forward(ctx, xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, save: bool):
        h, c = bilstm_forward(xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, with_c=save)
        if save:
            ctx.save_for_backward(xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h, c)
        return h

    @staticmethod
    def backward(ctx, g):
        xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h, c = ctx.saved_tensors
        dxw_f, dxw_b, lo_f, lo_b = bilstm_recurrence_backward(
            xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h, c, g.contiguous(), dgates=True)
        dw_f, dw_b = bilstm_dwhh(h, dxw_f, dxw_b, lo_f, lo_b)
        return dxw_f, dw_f, dxw_b, dw_b, None


def bilstm_recurrence(
    xw_fwd: torch.Tensor, w_hh_fwd: torch.Tensor, xw_bwd: torch.Tensor, w_hh_bwd: torch.Tensor
) -> torch.Tensor:
    """Both directions of a BiLSTM layer -> ``(B, T, 2H)``: the forward
    direction's ``h`` in ``[..., :H]``, the backward (reverse) one's in
    ``[..., H:]``, both in input time order.  Differentiable in all four
    inputs.

    CPU tensors take the plain versions; CUDA tensors launch ``lstm_fwd``
    once for both directions on the current stream (and, in backward,
    ``lstm_bwd`` and ``lstm_dwhh``), or raise.  The cell states are kept for
    backward only when grad mode is on and an input requires grad; otherwise
    (serving, ``torch.inference_mode``) the kernel writes ``h`` alone.
    """
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd)
    )
    return _BiLSTMRecurrence.apply(xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, save)


def _count(kernel: str, dtype: torch.dtype) -> None:
    """One launch of ``kernel`` in ``dtype``."""
    profiling.count(f"{kernel}_bf16" if dtype == torch.bfloat16 else kernel)


KERNELS = ("lstm_fwd", "lstm_bwd", "lstm_dwhh")
LAUNCH_COUNTERS = tuple(f"{name}{form}" for name in KERNELS for form in ("", "_bf16"))


def kernel_launches() -> dict:
    """Launches of each kernel form since the last reset: the f32 form
    under the kernel's name, the bf16 form under ``<name>_bf16``."""
    counts = profiling.counters()
    return {name: counts.get(name, 0) for name in LAUNCH_COUNTERS}


def reset_kernel_launches() -> None:
    profiling.reset_counters(LAUNCH_COUNTERS)

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
on CUDA tensors it launches the kernel or raises.  Launches are counted in
``bilstm_recurrence.launches`` (``lstm_fwd``, launched by
:func:`bilstm_forward`), ``bilstm_recurrence_backward.launches``
(``lstm_bwd``) and ``bilstm_dwhh.launches`` (``lstm_dwhh``); each also
counts its bf16 launches alone in ``.bf16_launches``.

Element types: f32 and bf16, one type for a layer's ``xw`` and ``W_hh``
(and so for ``h``, ``c``, the incoming gradient and ``dxw``).  bf16 runs as
the Pallas kernels run it (the JAX package's bf16 training): f32 carries,
``W_hh`` and ``xw`` upcast, ``h`` and ``c`` rounded to bf16 only where they
are stored; the backward recomputes the gates from the stored bf16
``h_prev`` and ``c``, stores ``dxw`` in bf16, and sums ``dW_hh`` in f32 from
the unrounded f32 ``dgates``, rounded to bf16 once at the end.  A CUDA
tensor of any other type, or of mixed types, raises.
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
    "ClusterPlan",
    "fwd_plan",
    "fwd_smem_bytes",
    "bwd_plan",
    "DwhhPlan",
    "dwhh_plan",
    "DTYPE_CODES",
    "bilstm_recurrence",
    "bilstm_recurrence_reference",
    "bilstm_forward",
    "bilstm_recurrence_backward",
    "bilstm_dwhh",
]

_PACKAGE = Path(__file__).resolve().parents[2]
SOURCES = {
    "lstm_fwd": _PACKAGE / "csrc" / "lstm_fwd.cu",
    "lstm_bwd": _PACKAGE / "csrc" / "lstm_bwd.cu",
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

# The element types the kernels are instantiated for, and their codes at the
# C interface (kF32, kBF16 in the sources).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
# C launchers of each source: name -> argument types (pointers, then B, T, H, stream).
_LAUNCHERS = {
    "lstm_fwd": {
        # xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_out, c_out (or null);
        # B, T, H, rows, cluster, ksplit, groups, dtype code
        "lstm_fwd_launch": [_P] * 6 + [_I] * 8 + [_P],
        # H, rows, cluster, ksplit, element bytes -> dynamic shared memory of a CTA, bytes
        "lstm_fwd_smem_bytes": [_I] * 5,
    },
    "lstm_bwd": {
        # xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h_seq, c_seq, g_out, dxw_fwd, dxw_bwd,
        # dg_fwd, dg_bwd (f32 dgates; null in f32); B, T, H, cluster, ksplit, dtype code
        "lstm_bwd_launch": [_P] * 11 + [_I] * 6 + [_P],
        # h_seq, dg_fwd, dg_bwd, part, dw_fwd, dw_bwd; B, T, H, slices, rows_per_slice,
        # dtype code (of h_seq and dw)
        "lstm_dwhh_launch": [_P] * 6 + [_I] * 6 + [_P],
        # H, cluster, ksplit, element bytes -> dynamic shared memory of a sweep CTA, bytes
        "lstm_bwd_smem_bytes": [_I] * 4,
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
        "/usr/local/cuda/bin): the LSTM kernels cannot be built"
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
    xw: torch.Tensor, w_hh: torch.Tensor, reverse: bool = False, return_c: bool = False
):
    """Plain PyTorch version of one direction of ``lstm_fwd``, ``(B, T, 4H)``
    -> ``h (B, T, H)`` (and ``c (B, T, H)`` too with ``return_c``): a Python
    loop over time with the same math
    (``ml_audio_inpainting_tpu/ops/lstm.py::lstm_scan`` from a zero state).

    bf16 inputs run as ``_fwd_kernel`` runs them: ``xw`` and ``W_hh``
    upcast, ``h`` and ``c`` carried in f32 and rounded to bf16 only where
    they are stored."""
    B, T, _ = xw.shape
    H = w_hh.shape[0]
    acc = _carry_dtype(xw.dtype)
    w_hh = w_hh.to(acc)
    h = xw.new_zeros((B, H), dtype=acc)
    c = xw.new_zeros((B, H), dtype=acc)
    h_seq = xw.new_empty((B, T, H))
    c_seq = xw.new_empty((B, T, H)) if return_c else None
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xw[:, t].to(acc) + h @ w_hh
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
):
    """Plain version of one direction of ``lstm_bwd``: ``dxw (B, T, 4H)``, the
    gradient of ``sum(h * g)`` for the direction's saved ``h``, ``c`` and
    incoming ``g``, all ``(B, T, H)``.  A Python loop over time with
    ``_bwd_kernel``'s math, sweeping against the forward recurrence's order;
    :func:`dwhh_reference` of its unrounded ``dgates`` is ``_bwd_kernel``'s
    ``dW_hh``.

    bf16 inputs run as ``_bwd_kernel`` runs them: the gates recomputed from
    the stored (bf16) ``h_prev`` and ``c`` and the upcast ``xw`` and
    ``W_hh``, the ``dh`` and ``dc`` carries in f32, and ``dgates`` rounded
    to bf16 only where it is stored as ``dxw``.  With ``return_dgates`` the
    result is ``(dxw, dgates)``, ``dgates`` unrounded (for f32 inputs the
    same values as ``dxw``)."""
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
    dg_seq = xw.new_empty(xw.shape) if return_dgates and acc != xw_in.dtype else None
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
        dh_carry = dgates @ w_hh.T
        dc_carry = dc * f
    if return_dgates:
        return dxw, (dxw if dg_seq is None else dg_seq)
    return dxw


def dwhh_reference(h: torch.Tensor, dgates: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Plain version of one direction of ``lstm_dwhh``:
    ``sum_{b,t} h_prev[b, t]^T dgates[b, t]`` for the direction's ``h (B, T,
    H)``, in ``h``'s type.  For bf16 ``h`` the sum runs in f32 over the
    upcast ``h`` and ``dgates`` (which the caller passes unrounded, in f32,
    as ``_bwd_kernel`` sums them) and is rounded once at the end."""
    acc = _carry_dtype(h.dtype)
    h_prev = _shift_prev(h, reverse).to(acc)
    dw = h_prev.reshape(-1, h.shape[-1]).T @ dgates.to(acc).reshape(-1, dgates.shape[-1])
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


def fwd_smem_bytes(plan: ClusterPlan, elem_bytes: int = 4) -> int:
    """Dynamic shared memory of an ``lstm_fwd`` CTA under ``plan`` for
    elements of ``elem_bytes`` bytes (4: f32, 2: bf16), as ``FwdLayout`` in
    ``csrc/lstm_fwd.cu`` lays it out: the f32 W_hh slice (row stride padded
    to an odd multiple of 4), two f32 h buffers (each row's k-slices in
    segments of ``FWD_MAX_HIDDEN / ksplit + 4`` floats) and ``FWD_STAGES``
    xw buffers of the element type."""
    ldw = 4 * ((plan.units + 1) | 1)
    ncol = 4 * plan.units
    hrow = plan.ksplit * (FWD_MAX_HIDDEN // plan.ksplit + 4)
    floats = plan.H * ldw + 2 * plan.rows * hrow
    return 4 * floats + _cdiv(elem_bytes * FWD_STAGES * plan.rows * ncol, 16) * 16


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


# ---------------------------------------------------------------- kernel wrappers


def _check_kernel_args(xw: torch.Tensor, w_hh: torch.Tensor) -> None:
    if xw.device.type != "cuda" or w_hh.device != xw.device:
        raise ValueError(
            f"LSTM kernel: xw on {xw.device} and w_hh on {w_hh.device}; the kernel "
            "needs them on one CUDA device (CPU tensors take the plain version)"
        )
    if xw.dtype not in DTYPE_CODES or w_hh.dtype != xw.dtype:
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
    ``lstm_fwd`` once for both directions on the clusters of
    :func:`fwd_plan` (``rows`` batch rows a cluster, by default the plan's
    choice; the result does not depend on it), counted in
    ``bilstm_recurrence.launches`` (and ``.bf16_launches`` in bf16), or
    raise.  ``h`` and ``c`` are in the inputs' type.
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
    plan = fwd_plan(B, H, rows)
    launch = load_library("lstm_fwd").cdll.lstm_fwd_launch
    xw_f, xw_b = _aligned16(xw_fwd), _aligned16(xw_bwd)
    with torch.cuda.device(h.device):
        rc = launch(*(t.data_ptr() for t in (xw_f, w_hh_fwd, xw_b, w_hh_bwd, h)),
                    None if c is None else c.data_ptr(), B, T, H, plan.rows, plan.cluster,
                    plan.ksplit, plan.groups, DTYPE_CODES[h.dtype], _stream(h.device))
    if rc != 0:
        raise RuntimeError(f"lstm_fwd launch failed with CUDA error {rc} (B={B}, T={T}, H={H}, "
                           f"{h.dtype}, {plan})")
    _count(bilstm_recurrence, h.dtype)
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
) -> Tuple[torch.Tensor, ...]:
    """``(dxw_fwd, dxw_bwd)``, the gradients of ``sum(h * g)`` with respect to
    a BiLSTM layer's projected inputs, in their type, given its forward
    inputs, its ``(B, T, 2H)`` outputs ``h`` and ``c``
    (:func:`bilstm_forward`) and the incoming gradient ``g``.  With
    ``dgates``, ``(dxw_fwd, dxw_bwd, dgates_fwd, dgates_bwd)``: the same
    gradients unrounded, in f32 (in f32 the ``dxw`` tensors themselves),
    which :func:`bilstm_dwhh` sums into ``dW_hh``.

    CPU tensors take :func:`lstm_recurrence_backward_reference` per
    direction; CUDA tensors launch ``lstm_bwd`` once for both directions
    (in bf16 it also writes the f32 dgates, into buffers allocated here,
    whether or not they are returned), or raise.
    """
    tensors = (xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h, c, g)
    if all(t.device.type == "cpu" for t in tensors):
        H = w_hh_fwd.shape[0]
        (dxw_f, dg_f), (dxw_b, dg_b) = (
            lstm_recurrence_backward_reference(
                xw_fwd, w_hh_fwd, h[..., :H], c[..., :H], g[..., :H], reverse=False,
                return_dgates=True),
            lstm_recurrence_backward_reference(
                xw_bwd, w_hh_bwd, h[..., H:], c[..., H:], g[..., H:], reverse=True,
                return_dgates=True),
        )
        return (dxw_f, dxw_b, dg_f, dg_b) if dgates else (dxw_f, dxw_b)
    _check_pair(xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd)
    B, T, _ = xw_fwd.shape
    H = w_hh_fwd.shape[0]
    for name, t in (("h", h), ("c", c), ("g", g)):
        _check_layer_seq(name, t, xw_fwd, 2 * H)
    dxw_f = torch.empty_like(xw_fwd)
    dxw_b = torch.empty_like(xw_bwd)
    if xw_fwd.dtype == torch.float32:
        dg_f, dg_b = dxw_f, dxw_b
        dg_ptrs = (None, None)
    else:
        dg_f, dg_b = (torch.empty(xw_fwd.shape, device=xw_fwd.device, dtype=torch.float32)
                      for _ in range(2))
        dg_ptrs = (dg_f.data_ptr(), dg_b.data_ptr())
    out = (dxw_f, dxw_b, dg_f, dg_b) if dgates else (dxw_f, dxw_b)
    if B == 0 or T == 0:
        return out
    plan = bwd_plan(B, H)
    launch = load_library("lstm_bwd").cdll.lstm_bwd_launch
    inputs = [_aligned16(t) for t in tensors]
    with torch.cuda.device(h.device):
        rc = launch(*(t.data_ptr() for t in (*inputs, dxw_f, dxw_b)), *dg_ptrs, B, T, H,
                    plan.cluster, plan.ksplit, DTYPE_CODES[xw_fwd.dtype], _stream(h.device))
    if rc != 0:
        raise RuntimeError(f"lstm_bwd launch failed with CUDA error {rc} (B={B}, T={T}, H={H}, "
                           f"{xw_fwd.dtype}, {plan})")
    _count(bilstm_recurrence_backward, xw_fwd.dtype)
    return out


def bilstm_dwhh(
    h: torch.Tensor, dgates_fwd: torch.Tensor, dgates_bwd: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dW_hh_fwd, dW_hh_bwd)`` in ``h``'s type, each
    ``sum_{b,t} h_prev[b, t]^T dgates[b, t]`` for its half of ``h (B, T,
    2H)``.  The dgates are f32 for bf16 ``h`` (the unrounded ones of
    :func:`bilstm_recurrence_backward`), else of ``h``'s type.

    CPU tensors take :func:`dwhh_reference`; CUDA tensors launch
    ``lstm_dwhh`` once for both directions (its f32 partial products over
    the slices of :func:`dwhh_plan`, then their sum in slice order, so the
    result does not change from run to run, rounded to ``h``'s type at the
    end), or raise.
    """
    H = h.shape[-1] // 2
    if all(t.device.type == "cpu" for t in (h, dgates_fwd, dgates_bwd)):
        return (dwhh_reference(h[..., :H], dgates_fwd, reverse=False),
                dwhh_reference(h[..., H:], dgates_bwd, reverse=True))
    if h.device.type != "cuda":
        raise ValueError(f"lstm_dwhh: h on {h.device}; the kernel needs CUDA tensors")
    if h.dtype not in DTYPE_CODES:
        raise TypeError(f"lstm_dwhh takes float32 or bfloat16 h, got {h.dtype}")
    for name, t in (("dgates_fwd", dgates_fwd), ("dgates_bwd", dgates_bwd)):
        _check_layer_seq(name, t, h, 4 * H, dtype=torch.float32)
    _check_layer_seq("h", h, h, 2 * H)
    B, T, _ = h.shape
    dw_f = torch.empty((H, 4 * H), device=h.device, dtype=h.dtype)
    dw_b = torch.empty_like(dw_f)
    if B == 0 or T == 0:
        return dw_f.zero_(), dw_b.zero_()
    plan = dwhh_plan(B, T, H)
    part = torch.empty(plan.partial_shape, device=h.device, dtype=torch.float32)
    launch = load_library("lstm_bwd").cdll.lstm_dwhh_launch
    inputs = [_aligned16(t) for t in (h, dgates_fwd, dgates_bwd)]
    with torch.cuda.device(h.device):
        rc = launch(*(t.data_ptr() for t in (*inputs, part, dw_f, dw_b)), B, T, H, plan.slices,
                    plan.rows_per_slice, DTYPE_CODES[h.dtype], _stream(h.device))
    if rc != 0:
        raise RuntimeError(f"lstm_dwhh launch failed with CUDA error {rc} (B={B}, T={T}, H={H}, "
                           f"{h.dtype}, {plan})")
    _count(bilstm_dwhh, h.dtype)
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
        dxw_f, dxw_b, dg_f, dg_b = bilstm_recurrence_backward(
            xw_fwd, w_hh_fwd, xw_bwd, w_hh_bwd, h, c, g.contiguous(), dgates=True)
        dw_f, dw_b = bilstm_dwhh(h, dg_f, dg_b)
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


def _count(wrapper, dtype: torch.dtype) -> None:
    """One launch of ``wrapper``'s kernel, in ``dtype``."""
    wrapper.launches += 1
    if dtype == torch.bfloat16:
        wrapper.bf16_launches += 1


bilstm_recurrence.launches = bilstm_recurrence.bf16_launches = 0
bilstm_recurrence_backward.launches = bilstm_recurrence_backward.bf16_launches = 0
bilstm_dwhh.launches = bilstm_dwhh.bf16_launches = 0
WRAPPERS = {"lstm_fwd": bilstm_recurrence, "lstm_bwd": bilstm_recurrence_backward,
            "lstm_dwhh": bilstm_dwhh}


def kernel_launches() -> dict:
    """Launches of each kernel form since the last reset: the f32 form
    under the kernel's name, the bf16 form under ``<name>_bf16``."""
    out = {}
    for name, wrapper in WRAPPERS.items():
        out[name] = wrapper.launches - wrapper.bf16_launches
        out[f"{name}_bf16"] = wrapper.bf16_launches
    return out


def reset_kernel_launches() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = wrapper.bf16_launches = 0

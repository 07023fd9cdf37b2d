"""The yardstick: one H100's published peaks, the least time of each LSTM
call from its shapes, and the kind of a device kernel by its name.

Peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W, dense:
989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in f32 outside them
(TF32 off), 3.35 TB/s of HBM.  A run prints the card's power limit beside
every share of a peak.

An LSTM call's least time is the larger of its bytes over the HBM rate and
its FLOPs over the peak of its element type, counting each input read once
and each output written once (both directions of a layer in one call):

* forward, ``lstm_fwd``: ``xw (B, T, 4H)`` and ``W_hh (H, 4H)`` in, ``h (B,
  T, H)`` out (and ``c`` when training keeps it); one ``(B, H) x (H, 4H)``
  product a step;
* backward as a whole, the sweep ``lstm_bwd`` and the ``dW_hh`` sum
  ``lstm_dwhh``: ``xw``, ``W_hh``, ``h``, ``c`` and the incoming ``g`` in,
  ``dxw`` and ``dW_hh`` out; three such products a step.
"""

from __future__ import annotations

import re
from typing import Optional

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}
ELEM_BYTES = {"float32": 4, "bfloat16": 2}


def least_seconds(bytes_moved: float, flops: float, dtype: str) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype])


def lstm_forward_work(b: int, t: int, h: int, dtype: str, keep_c: bool):
    """``(bytes, flops)`` of one ``lstm_fwd`` call, both directions."""
    e = ELEM_BYTES[dtype]
    outs = 2 if keep_c else 1
    return 2 * e * (b * t * 4 * h + h * 4 * h + outs * b * t * h), 2 * 2 * b * t * h * 4 * h


def lstm_backward_work(b: int, t: int, h: int, dtype: str):
    """``(bytes, flops)`` of one layer's backward (sweep and ``dW_hh`` sum),
    both directions."""
    e = ELEM_BYTES[dtype]
    reads = e * (2 * b * t * 4 * h + 2 * h * 4 * h + 3 * b * t * 2 * h)
    writes = e * (2 * b * t * 4 * h + 2 * h * 4 * h)
    return reads + writes, 3 * 2 * (2 * b * t * h * 4 * h)


# Kind of a device kernel by its name, first match wins (the port's profile
# scripts' classifiers, merged).
KINDS = (
    ("lstm_fwd", re.compile(r"lstm_fwd")),
    ("lstm_bwd", re.compile(r"lstm_bwd")),
    ("lstm_dwhh", re.compile(r"lstm_dwhh")),
    # BatchNorm's kernels, cuDNN's among them (before "cudnn" below).
    ("batchnorm", re.compile(r"batch_norm|batchnorm|bn_fw|bn_bw", re.I)),
    # cuDNN's NCHW <-> NHWC transposes around its channels-last kernels.
    ("layout_transpose", re.compile(r"nchwToNhwc|nhwcToNchw|transpose", re.I)),
    # cuDNN's own FFT convolutions (fft2d_*, with cudnn:: arguments) are convolutions.
    ("convolution", re.compile(r"conv|fprop|dgrad|wgrad|implicit_gemm|winograd|cudnn", re.I)),
    # cuBLAS's Hopper kernels (bf16 products) are named nvjet_*.
    ("matmul", re.compile(r"gemm|sgemm|cutlass|xmma|cublas|matmul|nvjet", re.I)),
    ("fft", re.compile(r"fft", re.I)),
    ("optimizer", re.compile(r"adam|multi_tensor", re.I)),
    # The partial convolutions' mask sums (a sum pool) and VGG19's max pools.
    ("pooling", re.compile(r"pool", re.I)),
    ("resize", re.compile(r"upsample|interp", re.I)),
    ("copy_cast", re.compile(r"copy_kernel|bfloat16_copy|CatArray|memcpy|memset", re.I)),
    ("reduction", re.compile(r"reduce_kernel", re.I)),
    ("elementwise", re.compile(r"elementwise_kernel|vectorized|unrolled", re.I)),
)


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if pattern.search(name):
            return kind
    return "other"


def share(numerator: float, denominator: float) -> Optional[float]:
    """``100 * numerator / denominator``, or None where there is nothing to
    divide by (a reader that finds nothing returns nothing)."""
    if not denominator or numerator is None:
        return None
    return 100.0 * numerator / denominator

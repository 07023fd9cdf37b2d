"""The numeric precision the port's entry points state for themselves.

PyTorch runs f32 matrix products in full f32 by default, but lets cuDNN
run f32 convolutions in TF32 (``torch.backends.cudnn.allow_tf32`` is True),
which keeps about three decimal digits.  The JAX reference and every
tolerance of the port are f32, so serving and training run their
convolutions with TF32 off, in a scope, whatever the global switch says.
"""

from __future__ import annotations

from contextlib import AbstractContextManager

import torch

__all__ = ["full_f32_convolutions"]


def full_f32_convolutions() -> AbstractContextManager:
    """A scope in which cuDNN convolutions (and their gradients, if the
    backward runs inside it) are computed in full f32; cuDNN's other
    settings stay as they are and every setting is restored on exit."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(
        enabled=cudnn.enabled,
        benchmark=cudnn.benchmark,
        benchmark_limit=cudnn.benchmark_limit,
        deterministic=cudnn.deterministic,
        allow_tf32=False,
    )

"""The numeric precision the port's entry points state for themselves.

PyTorch runs f32 matrix products in full f32 by default, but lets cuDNN
run f32 convolutions in TF32 (``torch.backends.cudnn.allow_tf32`` is True),
which keeps about three decimal digits.  The JAX reference and every
tolerance of the port are f32, so serving and training run their
convolutions with TF32 off, in a scope, whatever the global switch says;
the metrics whose matrix products are ill-conditioned (PEAQ's band
grouping) run them with TF32 off in the same way.

Mixed precision is a cast, as in the JAX package
(``ml_audio_inpainting_tpu/utils/precision.py::cast_floating``): the
floating tensors of a parameter tree go to the compute type, and every op
then runs in it.  It is not ``torch.autocast``, which keeps some ops in f32
and so computes something else.
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator, Mapping
from contextlib import AbstractContextManager

import torch

__all__ = ["cast_floating", "full_f32_convolutions", "full_f32_matmuls"]


def cast_floating(tree, dtype: torch.dtype):
    """``tree`` (a tensor, or mappings, lists and tuples of them, such as a
    module's ``state_dict`` or ``named_parameters``) with every floating
    tensor cast to ``dtype`` (differentiably: a cast's gradient flows back
    in the source's type); integer tensors and other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, Mapping):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree


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


@contextlib.contextmanager
def full_f32_matmuls() -> Iterator[None]:
    """A scope in which cuBLAS computes f32 matrix products in full f32
    (``torch.backends.cuda.matmul.allow_tf32`` off), whatever the switch
    says outside; it is restored on exit."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = before

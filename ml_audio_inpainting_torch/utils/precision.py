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

On the CPU, a bf16 convolution runs as the f32 convolution of the bf16
values with its result rounded to bf16 (:func:`conv`): oneDNN's bf16
convolution, forward and backward, can leave outputs unwritten (a result
one column wide; ``convolution_backward`` of the PatchGAN's last layer),
so they held whatever their memory held before.  The f32 path computes
the same sums in f32 and rounds once, as the bf16 kernels do.  The card
runs its bf16 convolutions in cuDNN, unchanged.
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator, Mapping
from contextlib import AbstractContextManager

import torch
import torch.nn.functional as F

__all__ = ["cast_floating", "conv", "full_f32_convolutions", "full_f32_matmuls"]


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


def conv(x: torch.Tensor, weight: torch.Tensor, bias=None, **kw) -> torch.Tensor:
    """``F.conv1d``/``F.conv2d`` (by ``weight``'s rank) of ``x`` with
    ``weight`` and ``bias`` and the keywords ``stride``, ``padding``,
    ``dilation``; on CPU tensors in bf16, the f32 convolution of the same
    values rounded to bf16 (the module docstring says why), differentiable
    back to the bf16 tensors."""
    fn = F.conv1d if weight.ndim == 3 else F.conv2d
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        return fn(x.float(), weight.float(), None if bias is None else bias.float(),
                  **kw).to(torch.bfloat16)
    return fn(x, weight, bias, **kw)

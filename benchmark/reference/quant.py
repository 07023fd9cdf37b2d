"""The precision the plain references compute in, and the roundings of the
lower-precision controls.

The references run in float32 with TF32 off (:func:`full_f32`).  A control
is the reference put in the program's place one precision step below what
the configuration states (:data:`CONTROLS`: the rounding of every operand of
every convolution and matrix product, the scope of the products, and the
type the network computes in):

* ``fp8`` (bfloat16 serving): the operands rounded to float8 (e4m3, one
  scale a tensor, :func:`fp8`), the rest in f32;
* ``bf16_fp8`` (bfloat16 training): the network run as the program runs
  it, on bfloat16 casts of the f32 parameters and inputs, with the operands
  rounded to float8;
* ``tf32`` (float32): the products in TF32 (:func:`tf32`).
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # the largest finite e4m3 value


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude at 448), back in ``x``'s type; the gradient passes
    straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    rounded = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (rounded - x).detach()


@contextlib.contextmanager
def _switches(on: bool):
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32, cudnn.allow_tf32 = on, on
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = before


def full_f32():
    """A scope with f32 products and convolutions in full f32."""
    return _switches(False)


def tf32():
    """A scope with f32 products and convolutions in TF32."""
    return _switches(True)


CONTROLS = {"fp8": (fp8, full_f32, None), "bf16_fp8": (fp8, full_f32, torch.bfloat16),
            "tf32": (identity, tf32, None)}

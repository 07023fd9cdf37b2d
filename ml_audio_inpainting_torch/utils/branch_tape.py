"""The branches a network's kinks take, recorded in one run and replayed in another.

A train step's gradients are not continuous where an activation has a kink.
A LeakyReLU or ReLU input within rounding of 0 takes one slope in f32 and
the other in f64, and a max pool's near-tie picks another input.  In the
GAN step one such LeakyReLU in an encoder block moves that block's
BatchNorm-bias gradient by 1e-3 of its largest entry, so an f32 step and its
f64 reference lie that far apart with no fault in either's arithmetic (on
an H100, ``scripts/torch_gan_step_precision.py``: up to 2.1e-3 from f64, and
1.5e-5 with the f64 step taking the f32 step's branches).  To compare the
two by their arithmetic alone, the reference
replays the f32 run's decisions: inside :func:`branch_tape`, the
``torch.nn.functional`` calls ``leaky_relu``, ``relu`` and ``max_pool2d``
(the modules' too: ``nn.ReLU`` and ``nn.MaxPool2d`` call them) and the
train-mode BatchNorm fused with its activation
(``ops/cuda/batchnorm.py::batch_norm_act``) record, or take from the tape,
which side of 0 each activation's input lies on and which input each pool
window passes on.
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator
from typing import List

import torch
import torch.nn.functional as F

from ml_audio_inpainting_torch.ops.cuda import batchnorm

__all__ = ["branch_tape"]


@contextlib.contextmanager
def branch_tape(tape: List[torch.Tensor], replay: bool = False) -> Iterator[None]:
    """A scope in which ``F.leaky_relu``, ``F.relu``, ``F.max_pool2d`` and
    ``batchnorm.batch_norm_act`` with an activation append to ``tape`` the
    branch each call takes (a bool tensor, the activation's input > 0, or
    the pool's argmax indices), in call order, and return what they return
    outside it; or, with ``replay``, take the branches from ``tape`` in the
    same order, whatever their own inputs say.  A replay must make the same
    calls on the same shapes (the same step, on any device and in any
    dtype), and use up the tape."""
    leaky_relu, relu, max_pool2d = F.leaky_relu, F.relu, F.max_pool2d
    batch_norm_act = batchnorm.batch_norm_act
    calls = [0]

    def branch(input: torch.Tensor, pooled: bool = False) -> torch.Tensor:
        """The next recorded branch, checked against the input it now
        applies to (a pool's: its batch and channels)."""
        i = calls[0]
        calls[0] += 1
        got = tape[i] if i < len(tape) else None
        if got is None or (got.shape[:2] if pooled else got.shape) != (
                input.shape[:2] if pooled else input.shape):
            raise RuntimeError(f"branch tape: call {i} of the replay does not match the recording "
                               f"({None if got is None else tuple(got.shape)} recorded, input "
                               f"{tuple(input.shape)} now)")
        return got.to(input.device)

    def tape_leaky_relu(input, negative_slope=0.01, inplace=False):
        if replay:
            return torch.where(branch(input), input, input * negative_slope)
        tape.append(input > 0)
        return leaky_relu(input, negative_slope, inplace)

    def tape_relu(input, inplace=False):
        if replay:
            return torch.where(branch(input), input, torch.zeros_like(input))
        tape.append(input > 0)
        return relu(input, inplace)

    def tape_max_pool2d(input, kernel_size, stride=None, padding=0, dilation=1,
                        ceil_mode=False, return_indices=False):
        if return_indices:
            raise NotImplementedError("branch tape: max_pool2d with return_indices")
        if replay:
            index = branch(input, pooled=True)
            return input.flatten(2).gather(2, index.flatten(2)).view(index.shape)
        out, index = F.max_pool2d_with_indices(input, kernel_size, stride, padding, dilation,
                                               ceil_mode)
        tape.append(index)
        return out

    def tape_batch_norm_act(*args, negative_slope=None):
        """Recorded from the fused run: its output's side of 0 is its
        activation's input's for a slope of 0 or more.  Replayed as the
        normalisation alone, then the activation on the recorded sides."""
        if negative_slope is None:
            return batch_norm_act(*args)
        if negative_slope < 0:
            raise NotImplementedError("branch tape: a BatchNorm activation of negative slope")
        if replay:
            y = batch_norm_act(*args)
            return torch.where(branch(y), y,
                               y * negative_slope if negative_slope else torch.zeros_like(y))
        out = batch_norm_act(*args, negative_slope=negative_slope)
        tape.append(out > 0)
        return out

    F.leaky_relu, F.relu, F.max_pool2d = tape_leaky_relu, tape_relu, tape_max_pool2d
    batchnorm.batch_norm_act = tape_batch_norm_act
    try:
        yield
        if replay and calls[0] != len(tape):
            raise RuntimeError(f"branch tape: the replay made {calls[0]} calls, the recording "
                               f"{len(tape)}")
    finally:
        F.leaky_relu, F.relu, F.max_pool2d = leaky_relu, relu, max_pool2d
        batchnorm.batch_norm_act = batch_norm_act

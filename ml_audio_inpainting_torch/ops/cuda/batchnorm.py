"""Flax's train-mode BatchNorm fused with the activation after it: the CUDA
kernels of ``csrc/batchnorm.cu``, their plain PyTorch version, and the
``torch.autograd.Function`` over them.

:func:`batch_norm_act` is the entry point, called by
``models/cnn_blstm.py::FlaxBatchNorm2d`` in train mode for every model of
the port (the CNN+BiLSTM's ReLU layers, the GAN generator's LeakyReLU(0.2)
blocks).  It computes, over an NCHW ``x`` in f32 or bf16 (the rule
``FlaxBatchNorm2d`` documents):

* ``mean = E[x]``, ``var = max(E[x^2] - mean^2, 0)`` over (N, H, W) in f32
  (over a mesh's global batch, :func:`~ml_audio_inpainting_torch.parallel.
  collectives.batch_sums`), and the running statistics moved by
  ``keep * running + (1 - keep) * batch`` when ``update``;
* ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias`` in f32, rounded
  to ``x``'s type, then the activation of that value (none for
  ``negative_slope`` None, ReLU for 0, LeakyReLU otherwise) as
  ``torch.relu`` or ``F.leaky_relu`` compute it in that type;
* backward, the derivative of that graph (the notes in the source), with
  ``weight`` and ``bias``'s gradients in their own type and ``x``'s
  rounded once to its type.

Only ``x`` and the per-channel mean and raw variance are kept for the
backward: the backward recomputes the normalised value and the activation's
side of 0 from them, bit for bit as the forward had them.

CPU tensors take the plain version (:func:`forward_reference`,
:func:`backward_reference`; f64 too).  A CUDA tensor launches the kernels,
two a pass (statistics then apply; channel sums then apply), or raises:
f32 or bf16 ``x``, ``weight`` and ``bias`` of one type (f32 or bf16), f32
running statistics.  The channel sums are a fixed two-stage tree, so a
launch repeats bit for bit.  Launches are counted on the program's
counters (``runtime/profiling.py::count``) as ``bn_fwd`` and ``bn_bwd``,
with ``_bf16`` after the name for bf16 ``x``: one after each pass's two
kernels have launched (:func:`kernel_launches`); the plain version
launches and counts nothing.  The library is built at the
first launch (``lstm_cell.load_library``), never at import.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ml_audio_inpainting_torch.ops.cuda.lstm_cell import load_library
from ml_audio_inpainting_torch.parallel.collectives import batch_moments, batch_sums
from ml_audio_inpainting_torch.runtime import profiling

__all__ = ["CHUNK", "plan", "activate", "forward_reference", "backward_reference",
           "forward_kernel", "backward_kernel", "batch_norm_act", "kernel_launches",
           "reset_kernel_launches"]

DIMS = (0, 2, 3)
# Elements of a (b, c) plane a block takes at most: two passes of its 256
# threads over 16-byte vectors, 4 in flight a thread, in bf16 (four in f32).
# At the production plane (257 x 417 = 107 169) a plane is 7 blocks, so even
# 16 channels at B=128 make 14 336 blocks for the 132 SMs.
CHUNK = 16384
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def plan(P: int) -> Tuple[int, int]:
    """``(chunks, chunk)``: a plane of ``P`` elements cut into ``chunks``
    blocks of ``chunk`` elements (the last one shorter)."""
    chunks = -(-P // CHUNK)
    return chunks, -(-P // chunks)


def activate(y: torch.Tensor, negative_slope: Optional[float]) -> torch.Tensor:
    """``y``, ``torch.relu(y)`` for slope 0, or ``F.leaky_relu(y, slope)``
    by its op, ``aten.leaky_relu``, which a branch tape does not replace:
    the tape records the fused Function whole."""
    if negative_slope is None:
        return y
    return torch.relu(y) if negative_slope == 0.0 else torch.ops.aten.leaky_relu(y, negative_slope)


# ---------------------------------------------------------------- plain version


def forward_reference(x, weight, bias, running_mean, running_var, num_batches_tracked,
                      update: bool, eps: float, keep: float,
                      negative_slope: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, saved)``: the rule's output and ``saved (C, 2)``, each
    channel's mean and raw variance ``E[x^2] - mean^2`` (before the clamp),
    for :func:`backward_reference`; the running statistics moved in place
    when ``update``.  The arithmetic of the eager rule: f32 (or f64) copies
    of ``x``, ``weight`` and ``bias``, :func:`batch_moments`."""
    acc = torch.promote_types(x.dtype, torch.float32)  # f32 for bf16, else x's own
    xf = x.to(acc)
    mean, mean_sq = batch_moments(xf, DIMS)
    var_raw = mean_sq - mean * mean
    var = torch.clamp_min(var_raw, 0.0)
    if update:
        running_mean.mul_(keep).add_((1.0 - keep) * mean)
        running_var.mul_(keep).add_((1.0 - keep) * var)
        num_batches_tracked.add_(1)
    mul = torch.rsqrt(var + eps) * weight.to(acc)
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bias.to(acc)[:, None, None]
    return activate(y.to(x.dtype), negative_slope), torch.stack([mean, var_raw], dim=1)


def backward_reference(dy, x, weight, bias, saved, eps: float,
                       negative_slope: Optional[float]) -> Tuple[torch.Tensor, ...]:
    """``(dx, dweight, dbias)`` of :func:`forward_reference` for the
    incoming ``dy``, written out: ``g``, the activation's backward of ``dy``
    in ``x``'s type, upcast; the channel sums ``Sg``, ``Sgc = sum g (x -
    mean)`` (this rank's for ``dbias = Sg`` and ``dweight = Sgc r``, the
    global batch's for ``dx``); ``dvar = -Sgc weight r^3 / 2`` where the
    raw variance is not negative; ``dx = g m + dmean / N + 2 x dvar / N``
    with ``r = rsqrt(var + eps)``, ``m = r weight``, ``dmean = -Sg m - 2
    mean dvar``."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    mean, var_raw = saved[:, 0], saved[:, 1]
    r = torch.rsqrt(torch.clamp_min(var_raw, 0.0) + eps)
    w = weight.to(acc)
    m = r * w
    xc = xf - mean[:, None, None]
    g = dy
    if negative_slope is not None:
        y = (xc * m[:, None, None] + bias.to(acc)[:, None, None]).to(x.dtype)
        g = torch.where(y > 0, dy, dy * negative_slope if negative_slope else torch.zeros_like(dy))
    gf = g.to(acc)
    local = torch.stack([gf.sum(DIMS), (gf * xc).sum(DIMS)], dim=1)
    dbias, dweight = local[:, 0].to(bias.dtype), (local[:, 1] * r).to(weight.dtype)
    total, ranks = batch_sums(local)
    n = ranks * (x.numel() // x.shape[1])
    dvar = torch.where(var_raw >= 0, -0.5 * total[:, 1] * w * r * r * r, torch.zeros_like(r))
    dmean = -total[:, 0] * m - 2.0 * mean * dvar
    dx = gf * m[:, None, None] + (dmean / n)[:, None, None] + xf * (2.0 * dvar / n)[:, None, None]
    return dx.to(x.dtype), dweight, dbias


# ---------------------------------------------------------------- kernels


def _check_activation(name: str, t: torch.Tensor, like: Optional[torch.Tensor] = None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"batchnorm kernel: {name} on {t.device}; the kernels need CUDA "
                         "tensors (CPU tensors take the plain version)")
    if t.dtype not in KERNEL_DTYPES or t.dim() != 4:
        raise TypeError(f"batchnorm kernel takes 4-D float32 or bfloat16 {name}, got "
                        f"{t.dtype} {tuple(t.shape)}")
    if like is not None and (t.shape != like.shape or t.dtype != like.dtype
                             or t.device != like.device):
        raise ValueError(f"batchnorm kernel: {name} {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"against x {like.dtype} {tuple(like.shape)} on {like.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"batchnorm kernel takes a contiguous {name} starting on 16 bytes")
    if t.numel() == 0:
        raise ValueError(f"batchnorm kernel: empty {name} {tuple(t.shape)}")


def _check_channels(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    *stats: torch.Tensor) -> None:
    C = x.shape[1]
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (C,) or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"batchnorm kernel: {name} {tuple(t.shape)} on {t.device}, "
                             f"expected contiguous ({C},) on {x.device}")
    if weight.dtype not in KERNEL_DTYPES or bias.dtype != weight.dtype:
        raise TypeError(f"batchnorm kernel takes float32 or bfloat16 weight and bias of one "
                        f"type, got {weight.dtype}/{bias.dtype}")
    for t in stats:
        if (t.dtype != torch.float32 or t.shape != (C,) or t.device != x.device
                or not t.is_contiguous()):
            raise TypeError(f"batchnorm kernel takes contiguous float32 ({C},) running "
                            f"statistics on {x.device}, got {t.dtype} {tuple(t.shape)} on "
                            f"{t.device}")


def _geometry(x: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """``(B, C, P, chunks, chunk)`` of a launch over ``x``."""
    B, C, H, W = x.shape
    chunks, chunk = plan(H * W)
    if B * C * chunks >= 2 ** 31:
        raise ValueError(f"batchnorm kernel: {B * C * chunks} blocks for {tuple(x.shape)}")
    return B, C, H * W, chunks, chunk


def _launched(rc: int, kernel: str, x: torch.Tensor) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {rc} ({x.dtype}, "
                           f"{tuple(x.shape)})")


def forward_kernel(x, weight, bias, running_mean, running_var, num_batches_tracked,
                   update: bool, eps: float, keep: float, negative_slope: Optional[float]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`forward_reference` on the card: ``bn_fwd_stats_kernel`` (the
    channel sums), then ``bn_fwd_apply_kernel`` (``y``, ``saved``, the
    running statistics); counts ``bn_fwd``.  Returns ``(y, saved,
    counter)``; the channel counters (zero again after each launch) serve
    the backward's sums."""
    _check_activation("x", x)
    _check_channels(x, weight, bias, running_mean, running_var)
    if num_batches_tracked.dtype != torch.int64 or num_batches_tracked.device != x.device:
        raise TypeError("batchnorm kernel takes an int64 num_batches_tracked on x's device")
    B, C, P, chunks, chunk = _geometry(x)
    dev = x.device
    counter = torch.zeros(C, dtype=torch.int32, device=dev)
    partial = torch.empty((C, B * chunks, 2), dtype=torch.float32, device=dev)
    sums = torch.empty((C, 2), dtype=torch.float32, device=dev)
    saved = torch.empty((C, 2), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    bf16 = int(x.dtype == torch.bfloat16)
    lib = load_library("batchnorm").cdll
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launched(lib.bn_fwd_stats_launch(x.data_ptr(), partial.data_ptr(), sums.data_ptr(),
                                          counter.data_ptr(), bf16, B, C, P, chunks, chunk,
                                          stream), "bn_fwd_stats", x)
        total, ranks = batch_sums(sums)
        _launched(lib.bn_fwd_apply_launch(
            x.data_ptr(), y.data_ptr(), total.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            int(weight.dtype == torch.bfloat16), saved.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), num_batches_tracked.data_ptr(), int(update),
            float(ranks * B * P), eps, keep, 1.0 - keep, int(negative_slope is not None),
            negative_slope or 0.0, bf16, B, C, P, chunks, chunk, stream), "bn_fwd_apply", x)
    _count("bn_fwd", x.dtype)
    return y, saved, counter


def backward_kernel(dy, x, weight, bias, saved, counter, eps: float,
                    negative_slope: Optional[float]) -> Tuple[torch.Tensor, ...]:
    """:func:`backward_reference` on the card: ``bn_bwd_reduce_kernel``
    (``Sg``, ``Sgc``, and from this rank's sums ``dweight`` and ``dbias``),
    then ``bn_bwd_apply_kernel`` (``dx``); counts ``bn_bwd``.  ``counter``
    is the forward's."""
    _check_activation("x", x)
    _check_activation("dy", dy, like=x)
    _check_channels(x, weight, bias)
    B, C, P, chunks, chunk = _geometry(x)
    dev = x.device
    partial = torch.empty((C, B * chunks, 2), dtype=torch.float32, device=dev)
    sums = torch.empty((C, 2), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dweight, dbias = torch.empty_like(weight), torch.empty_like(bias)
    bf16, param_bf16 = int(x.dtype == torch.bfloat16), int(weight.dtype == torch.bfloat16)
    act, slope = int(negative_slope is not None), negative_slope or 0.0
    lib = load_library("batchnorm").cdll
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launched(lib.bn_bwd_reduce_launch(
            x.data_ptr(), dy.data_ptr(), saved.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            param_bf16, partial.data_ptr(), sums.data_ptr(), counter.data_ptr(),
            dweight.data_ptr(), dbias.data_ptr(), eps, act, slope, bf16, B, C, P, chunks, chunk,
            stream), "bn_bwd_reduce", x)
        total, ranks = batch_sums(sums)
        _launched(lib.bn_bwd_apply_launch(
            x.data_ptr(), dy.data_ptr(), saved.data_ptr(), total.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), param_bf16, dx.data_ptr(), float(ranks * B * P), eps, act, slope,
            bf16, B, C, P, chunks, chunk, stream), "bn_bwd_apply", x)
    _count("bn_bwd", x.dtype)
    return dx, dweight, dbias


class _BatchNormAct(torch.autograd.Function):
    """The plain version on the CPU, the kernels on the card."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, num_batches_tracked,
                update, eps, keep, negative_slope):
        args = (x, weight, bias, running_mean, running_var, num_batches_tracked, update, eps,
                keep, negative_slope)
        if x.device.type == "cpu":
            (y, saved), counter = forward_reference(*args), None
        else:
            y, saved, counter = forward_kernel(*args)
        ctx.save_for_backward(x, weight, bias, saved, counter)
        ctx.eps, ctx.negative_slope = eps, negative_slope
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias, saved, counter = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dweight, dbias = backward_reference(dy, x, weight, bias, saved, ctx.eps,
                                                    ctx.negative_slope)
        else:
            dx, dweight, dbias = backward_kernel(dy.contiguous(), x, weight, bias, saved,
                                                 counter, ctx.eps, ctx.negative_slope)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dweight if need[1] else None,
                dbias if need[2] else None, None, None, None, None, None, None, None)


def batch_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor,
                   num_batches_tracked: torch.Tensor, update: bool, eps: float, keep: float,
                   negative_slope: Optional[float] = None) -> torch.Tensor:
    """The train-mode rule over ``x (B, C, H, W)`` and the activation after
    it (module docstring), differentiable in ``x``, ``weight`` and ``bias``;
    the running statistics move in place when ``update``.  A non-contiguous
    ``x`` on the card is copied first.  Callers reach it as
    ``batchnorm.batch_norm_act``, so that a branch tape
    (``utils/branch_tape.py``), which replaces it while open, sees them."""
    if x.device.type != "cpu":
        x = x.contiguous()
    return _BatchNormAct.apply(x, weight, bias, running_mean, running_var, num_batches_tracked,
                               update, eps, keep, negative_slope)


def _count(name: str, dtype: torch.dtype) -> None:
    profiling.count(f"{name}_bf16" if dtype == torch.bfloat16 else name)


KERNELS = ("bn_fwd", "bn_bwd")
LAUNCH_COUNTERS = tuple(f"{name}{form}" for name in KERNELS for form in ("", "_bf16"))


def kernel_launches() -> dict:
    """Launches of the forward's two kernels (``bn_fwd``) and of the
    backward's (``bn_bwd``) since the last reset, ``_bf16`` after the name
    for bf16 ``x``."""
    counts = profiling.counters()
    return {name: counts.get(name, 0) for name in LAUNCH_COUNTERS}


def reset_kernel_launches() -> None:
    profiling.reset_counters(LAUNCH_COUNTERS)

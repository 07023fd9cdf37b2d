"""The collectives the sharded steps run (what GSPMD inserts in the JAX
package), and the mesh they run on.

The models, losses and trainers call the functions here unconditionally.
Inside ``with use_mesh(mesh):`` they reduce over the active mesh's
groups; outside it, or on an axis of size 1, each is exactly the
expression it stands for (``x @ w``, ``F.linear``, ``x.mean()``, ...), so
the one-device path is unchanged bit for bit (rule 4 of
:mod:`ml_audio_inpainting_torch.parallel`).

* :func:`global_sum`, :func:`global_mean`, :func:`global_max`: the
  reductions a loss ends in, over the ``data`` group, identity backward;
* :func:`batch_moments`: BatchNorm's ``E[x]`` and ``E[x^2]`` over the
  global batch, whose backward sums the partial gradients over ``data``;
* :func:`row_parallel_matmul`, :func:`column_parallel_linear`: Megatron's
  pair over the ``model`` group, partial sums in f32 and rounded once;
* :func:`sum_gradients`: rule 2, the summed gradients over ``data``, and
  the replicated parameters' gradients equal on every rank of ``model``;
* :func:`all_gather_rows`: a batch's rows from every data rank.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ml_audio_inpainting_torch.parallel.mesh import Mesh

__all__ = ["use_mesh", "global_sum", "global_mean", "global_max", "batch_moments",
           "row_parallel_matmul", "column_parallel_linear", "sum_gradients", "all_gather_rows",
           "all_gather_cat"]

_ACTIVE: ContextVar[Optional[Mesh]] = ContextVar("ml_audio_inpainting_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[None]:
    """The scope in which the hooks reduce over ``mesh``'s groups."""
    token = _ACTIVE.set(mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def _axis(axis: str) -> Tuple[object, int, int]:
    """``(group, size, index)`` of the active mesh along ``axis``; group None
    outside a mesh or on an axis of size 1."""
    mesh = _ACTIVE.get()
    if mesh is None or mesh.shape[axis] == 1:
        return None, 1, 0
    return mesh.group(axis), mesh.shape[axis], mesh.index(axis)


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The reduction type: f32 for bf16 and f32, f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks of ``t`` from every rank of ``group``, concatenated along
    ``dim`` in rank order.  int16 travels as int32 (neither gloo nor NCCL
    takes int16), exactly."""
    size = dist.get_world_size(group)
    wire = t.to(torch.int32) if t.dtype == torch.int16 else t.contiguous()
    parts = [torch.empty_like(wire) for _ in range(size)]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts, dim=dim).to(t.dtype)


class _LossSum(torch.autograd.Function):
    """``all_reduce`` sum forward; identity backward (the loss is the same
    on every rank, each rank's gradient already the whole one)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SyncedSum(torch.autograd.Function):
    """``all_reduce`` sum forward and backward: the sum feeds each rank's
    own activations, so each rank's gradient of it is a partial one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a rank's sum) summed over the ``data`` group, in ``x``'s type
    (the losses' f32); ``x`` itself outside a mesh."""
    group, _, _ = _axis("data")
    return x if group is None else _LossSum.apply(x, group)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch: ``torch.mean(x)`` outside a
    mesh; inside, the summed ranks' sums over ``data`` times ``x.numel()``
    (every rank holds an equal share of the batch)."""
    group, size, _ = _axis("data")
    if group is None:
        return torch.mean(x)
    return _LossSum.apply(x.sum(), group) / (x.numel() * size)


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The largest element of ``x`` over the global batch (no gradient)."""
    group, _, _ = _axis("data")
    if group is None:
        return x.max()
    out = x.detach().max().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def batch_moments(x: torch.Tensor, dims: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(E[x], E[x^2])`` over ``dims`` of the global batch: ``x.mean(dims)``
    and ``(x * x).mean(dims)`` outside a mesh; inside, both sums in one
    ``all_reduce`` over ``data`` whose backward sums the gradients too."""
    group, size, _ = _axis("data")
    if group is None:
        return x.mean(dim=dims), (x * x).mean(dim=dims)
    count = size
    for d in dims:
        count *= x.shape[d]
    sums = _SyncedSum.apply(torch.stack([x.sum(dim=dims), (x * x).sum(dim=dims)]), group)
    return sums[0] / count, sums[1] / count


class _RowParallelMatmul(torch.autograd.Function):
    """``x[..., slice] @ w`` summed over the ``model`` group: the partial
    products in f32 (or wider), summed, rounded once to ``x``'s type.  The
    backward's products are whole on each rank: ``dw`` from this rank's
    slice, ``dx``'s slices gathered."""

    @staticmethod
    def forward(ctx, x, w, group, index):
        k = w.shape[0]
        xs = x[..., index * k:(index + 1) * k]
        acc = _acc(x.dtype)
        out = torch.matmul(xs.to(acc), w.to(acc))
        dist.all_reduce(out, group=group)
        ctx.save_for_backward(xs, w)
        ctx.group = group
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        xs, w = ctx.saved_tensors
        dx = all_gather_cat(torch.matmul(g, w.t()), ctx.group, dim=-1)
        dw = xs.reshape(-1, w.shape[0]).t() @ g.reshape(-1, w.shape[1])
        return dx, dw, None, None


def row_parallel_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a ``w`` ``(K, N)`` that may be this rank's ``(K / m,
    N)`` block of rows (the BiLSTM's ``w_ih`` under ``P("model", None)``);
    ``x`` ``(..., K)`` is replicated over ``model``."""
    group, _, index = _axis("model")
    if group is None or w.shape[0] == x.shape[-1]:
        return x @ w
    return _RowParallelMatmul.apply(x, w, group, index)


class _ColumnParallelLinear(torch.autograd.Function):
    """``x @ w.T`` for this rank's ``(N / m, K)`` block of output rows,
    gathered over the ``model`` group.  Backward: this rank's slice of the
    output gradient; ``dx``'s partial products in f32, summed over
    ``model`` and rounded once."""

    @staticmethod
    def forward(ctx, x, w, group, index):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.index = group, index
        return all_gather_cat(F.linear(x, w), group, dim=-1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        n = w.shape[0]
        gs = g[..., ctx.index * n:(ctx.index + 1) * n]
        acc = _acc(x.dtype)
        dx = torch.matmul(gs.to(acc), w.to(acc))
        dist.all_reduce(dx, group=ctx.group)
        dw = gs.reshape(-1, n).t() @ x.reshape(-1, w.shape[1])
        return dx.to(x.dtype), dw, None, None


def column_parallel_linear(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` for a ``weight`` ``(N, K)`` that may be
    this rank's ``(N / m, K)`` block (the dense ``projection`` under JAX's
    ``P(None, "model")``); ``bias`` ``(N,)`` is replicated."""
    group, _, index = _axis("model")
    if group is None or weight.shape[0] == bias.shape[0]:
        return F.linear(x, weight, bias)
    return _ColumnParallelLinear.apply(x, weight, group, index) + bias


def _flat_collective(grads: Sequence[torch.Tensor], op) -> None:
    """``op`` on the concatenation of ``grads``, one buffer a dtype, copied back."""
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = _flatten_dense_tensors(same)
        op(flat)
        for g, s in zip(same, _unflatten_dense_tensors(flat, same)):
            g.copy_(s)


def sum_gradients(params: Iterable[torch.Tensor], split: Iterable[torch.Tensor] = ()) -> None:
    """Rule 2: every ``.grad`` of ``params`` summed over the ``data`` group,
    in place.  Then the gradients of the parameters not in ``split`` (those
    replicated over ``model``) are the ``model`` group's first rank's on
    every rank of it: each model rank computes them from the same rows, but
    a kernel free to pick its summation order (cuDNN's weight gradients) can
    round them apart, and the replicas would drift."""
    grads = [p.grad for p in params if p.grad is not None]
    group, _, _ = _axis("data")
    if group is not None:
        _flat_collective(grads, lambda t: dist.all_reduce(t, group=group))
    mesh, (model, _, _) = _ACTIVE.get(), _axis("model")
    if model is not None:
        skip = {id(p.grad) for p in split}
        first = mesh.ranks[mesh.index("data") * mesh.shape["model"]]
        _flat_collective([g for g in grads if id(g) not in skip],
                         lambda t: dist.broadcast(t, src=first, group=model))


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t``'s rows from every data rank of ``mesh``, in rank order (``t``
    itself on a data axis of size 1)."""
    group = mesh.group("data")
    return t if group is None else all_gather_cat(t, group, dim=0)

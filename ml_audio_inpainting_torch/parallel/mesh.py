"""The ``(data, model)`` mesh of ranks (port of
``ml_audio_inpainting_tpu/parallel/mesh.py``).

A :class:`Mesh` lays ``data x model`` ranks out row-major: the ranks of one
data row share its batch rows and split the model's sharded tensors, and
the ranks of one model column hold the same shards and split the batch.
Each rank keeps its own ``data`` group (its model column) and ``model``
group (its data row); an axis of size 1 has no group.

Processes join with :func:`initialize_distributed`: from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), or from a store
(``parallel/launch.py`` hands each rank a ``FileStore``).  The backend is
NCCL where each rank has a card of its own, and gloo on the CPU and where
ranks share a card (NCCL refuses two ranks on one device: "Duplicate GPU
detected").  Gloo reduces CUDA tensors where they lie; no tensor is moved
to pick a backend.
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "Sharding",
    "initialize_distributed",
    "rank_device",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
]

LOG = logging.getLogger(__name__)
AXES = ("data", "model")


def rank_device(device, local_rank: int, local_world: int) -> Tuple[torch.device, str]:
    """``(device, backend)`` of a rank: the CPU with gloo; on CUDA, card
    ``local_rank`` with NCCL when the host has a card a rank, else card
    ``local_rank % count`` shared with other ranks, with gloo."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.device("cpu"), "gloo"
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("a CUDA rank was asked for but no card is visible")
    if count >= local_world:
        return torch.device("cuda", local_rank), "nccl"
    return torch.device("cuda", local_rank % count), "gloo"


def initialize_distributed(
    device="cuda",
    store: Optional[dist.Store] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> torch.device:
    """Join the run's process group and return this rank's device.

    With ``store``, ``rank`` and ``world_size`` come from the caller; without
    it, from torchrun's environment.  In a lone process (no store and
    ``WORLD_SIZE`` unset or 1) nothing is initialised and ``device`` comes
    back as it is.  ``backend`` overrides :func:`rank_device`'s choice.
    The backend in use is logged."""
    env = os.environ
    if store is None:
        world_size = int(env.get("WORLD_SIZE", "1"))
        if world_size <= 1:
            return torch.device(device)
        rank = int(env["RANK"])
    if rank is None or world_size is None:
        raise ValueError("a store needs rank and world_size")
    local_rank = int(env.get("LOCAL_RANK", rank)) if store is None else rank
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size)) if store is None else world_size
    dev, chosen = rank_device(device, local_rank, local_world)
    backend = backend or chosen
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"store": store} if store is not None else {"init_method": "env://"}
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    LOG.info("rank %d of %d: backend %s on %s", rank, world_size, backend, dev)
    return dev


@dataclass(frozen=True)
class Sharding:
    """Which dimension of a tensor is split over which mesh axis (JAX's
    ``NamedSharding`` with one named dimension); ``axis=None`` is
    replicated."""

    axis: Optional[str] = None
    dim: int = 0

    def local(self, t: torch.Tensor, mesh: "Mesh") -> torch.Tensor:
        """This rank's block of ``t`` (a view), or ``t`` when replicated."""
        if self.axis is None:
            return t
        parts, index = mesh.shape[self.axis], mesh.index(self.axis)
        size = t.shape[self.dim]
        if size % parts:
            raise ValueError(f"dimension {self.dim} of size {size} not divisible by "
                             f"{self.axis} axis {parts}")
        block = size // parts
        return t.narrow(self.dim, index * block, block)


REPLICATED = Sharding()


@dataclass(frozen=True, eq=False)
class Mesh:
    """``shape`` ``{"data": d, "model": m}`` over ``ranks`` (global ranks,
    row-major), this process's global ``rank``, its ``device``, and its
    group along each axis (``None`` for an axis of size 1, and on a rank
    outside the mesh) and of the whole mesh (``"mesh"``, ``None`` for a
    mesh of one rank)."""

    shape: Dict[str, int]
    ranks: Tuple[int, ...]
    rank: int
    device: torch.device
    groups: Dict[str, Any]

    @property
    def is_member(self) -> bool:
        return self.rank in self.ranks

    @property
    def coords(self) -> Tuple[int, int]:
        """``(data index, model index)`` of this rank."""
        if not self.is_member:
            raise ValueError(f"rank {self.rank} is outside the mesh {self.ranks}")
        return divmod(self.ranks.index(self.rank), self.shape["model"])

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        return self.groups[axis]

    @property
    def is_primary(self) -> bool:
        """The mesh's first rank: the one that logs and writes."""
        return self.rank == self.ranks[0]


def make_mesh(
    data_parallel: int = -1,
    model_parallel: int = 1,
    ranks: Optional[Sequence[int]] = None,
    device=None,
) -> Mesh:
    """A ``(data, model)`` mesh over ``ranks`` (every rank of the process
    group, or the one lone process, by default); ``data_parallel = -1``
    takes every rank not claimed by ``model``.  Every rank of the process
    group calls this with the same arguments (groups are made
    collectively), ranks outside ``ranks`` included.  ``device`` is this
    rank's device (the CPU by default)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = tuple(range(world) if ranks is None else ranks)
    n = len(ranks)
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(f"model_parallel={model_parallel} does not divide {n} ranks")
    if data_parallel == -1:
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(f"mesh {data_parallel}x{model_parallel} != {n} available ranks")
    outside = [r for r in ranks if not 0 <= r < world]
    if outside or len(set(ranks)) != n:
        raise ValueError(f"ranks {list(ranks)} are not distinct ranks of a world of {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    d, m = data_parallel, model_parallel
    groups: Dict[str, Any] = {"data": None, "model": None, "mesh": None}
    member = rank in ranks
    where = divmod(ranks.index(rank), m) if member else None
    if d > 1:
        for k in range(m):
            g = dist.new_group([ranks[i * m + k] for i in range(d)])
            if where is not None and where[1] == k:
                groups["data"] = g
    if m > 1:
        for i in range(d):
            g = dist.new_group([ranks[i * m + k] for k in range(m)])
            if where is not None and where[0] == i:
                groups["model"] = g
    if n > 1:
        g = dist.new_group(list(ranks))
        groups["mesh"] = g if member else None
    return Mesh({"data": d, "model": m}, ranks, rank,
                torch.device(device if device is not None else "cpu"), groups)


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch) dimension split over the ``data`` axis."""
    return Sharding("data", 0)


def replicated(mesh: Mesh) -> Sharding:
    return REPLICATED


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a host (or device) batch, on its device: a
    tensor or array, or a tuple or list of them.  The model ranks of one
    data row get the same rows; a batch that does not divide by the
    ``data`` axis raises ``ValueError``."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh) for b in batch)
    t = torch.as_tensor(batch)
    n_data = mesh.shape["data"]
    if t.shape[0] % n_data:
        raise ValueError(f"batch {t.shape[0]} not divisible by data axis {n_data}")
    return batch_sharding(mesh).local(t, mesh).to(mesh.device).contiguous()

"""Start ``world`` ranks of one program on this host (the port's counterpart
of the JAX package's virtual-device subprocess; ``torchrun`` is the other
way in, through ``initialize_distributed``'s environment path).

:func:`spawn` starts the ranks with the ``spawn`` start method (never
``fork``: a parent that has initialised CUDA cannot fork a child that uses
it), and they meet through a ``FileStore`` in a temporary directory, so
concurrent launches (pytest workers) never compete for a TCP port.  Each
rank joins the process group (``initialize_distributed``: NCCL where each
rank has a card of its own, gloo on the CPU and where ranks share a card),
runs ``fn(device, *args)`` with the LSTM kernels' launch counters at zero,
and sends back what ``fn`` returned (which must pickle: CPU tensors, numpy
arrays, plain values) with its launch counts.  As with any ``spawn``
start, a script that calls :func:`spawn` does so under ``if __name__ ==
"__main__":`` (each rank imports the main module).  On the CPU a rank runs one
torch thread.  A rank that raises, or dies, fails the call: the others are
stopped and the rank's traceback is raised in the parent.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ml_audio_inpainting_torch.ops.cuda.lstm_cell import kernel_launches, reset_kernel_launches
from ml_audio_inpainting_torch.parallel.mesh import initialize_distributed

__all__ = ["RankResult", "spawn"]


@dataclass
class RankResult:
    """What one rank returned, and its kernel launches by form
    (``ops/cuda/lstm_cell.py::kernel_launches``)."""

    rank: int
    value: Any
    kernel_launches: Dict[str, int]


def _child(rank: int, world: int, store_path: str, device: str, backend: Optional[str],
           timeout_s: float, fn: Callable, args: tuple, results) -> None:
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        store = dist.FileStore(store_path, world)
        dev = initialize_distributed(device, store=store, rank=rank, world_size=world,
                                     backend=backend, timeout_s=timeout_s)
        reset_kernel_launches()
        # By value (plain pickle): torch's queue pickler would share tensors
        # through file descriptors that die with this process.
        value = pickle.dumps(fn(dev, *args))
        results.put((rank, True, value, kernel_launches()))
    except BaseException:
        results.put((rank, False, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, device, *args, backend: Optional[str] = None,
          timeout_s: float = 600.0) -> List[RankResult]:
    """Run ``fn(device, *args)`` on ``world`` new ranks on ``device``'s kind
    (``"cpu"`` or ``"cuda"``) and return each rank's :class:`RankResult`,
    in rank order.  ``fn`` is a module-level function (it is pickled by
    name); ``backend`` overrides the backend choice.  Raises
    ``RuntimeError`` when a rank fails or dies, ``TimeoutError`` after
    ``timeout_s``."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ml_audio_inpainting_torch_store_")
    store_path = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_child, args=(rank, world, store_path, str(device), backend,
                                               timeout_s, fn, args, results))
             for rank in range(world)]
    done: Dict[int, RankResult] = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(done) < world:
            try:
                rank, ok, value, launches = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in done]
                if dead:
                    # A last look: its result may have been in flight as it exited.
                    try:
                        rank, ok, value, launches = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(f"rank {dead[0][0]} exited with code {dead[0][1]} "
                                           "and no result") from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish in {timeout_s} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            done[rank] = RankResult(rank, pickle.loads(value), launches)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [done[r] for r in range(world)]

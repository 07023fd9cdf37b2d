"""Host -> device input pipeline (port of
``ml_audio_inpainting_tpu/data/pipeline.py``).

* :func:`batch_iterator` yields ``(B, max_samples)`` f32 waveform batches,
  decoding items on a bounded-window thread pool (the native codec's calls
  release the GIL) in the serial order: epoch ``e`` is ``range(len)``
  shuffled by ``np.random.default_rng(seed + e)``, the last short batch
  dropped (``drop_last``);
* :func:`prefetch_to_device` copies the next batches to the card from a
  producer thread while the current step runs: pinned host buffers and
  ``non_blocking`` copies on a side stream, which the consuming stream
  waits for;
* :func:`device_corpus_feed` uploads the whole corpus to the card once and
  assembles every batch there with a gather: per step the host sends only
  the ``(B,)`` index vector.  Its order is :func:`batch_iterator`'s with
  ``shuffle=True``.

Both device feeds hand over a batch inside a host-only ``feed.next`` span
(``runtime/profiling.py``), closed before the batch is yielded.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from ml_audio_inpainting_torch.runtime.profiling import span

__all__ = ["batch_iterator", "prefetch_to_device", "device_corpus_feed"]


def _epoch_order(n: int, shuffle: bool, seed: int, epoch: int) -> np.ndarray:
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    return order


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    epochs: Optional[int] = None,
    workers: int = 0,
) -> Iterator[np.ndarray]:
    """``(B, max_samples)`` f32 numpy batches of ``dataset`` for ``epochs``
    epochs (forever with None).  ``workers > 0`` decodes through a thread
    pool with ``2 * workers * batch_size`` items in flight, in the same
    order as the serial loop."""
    executor = ThreadPoolExecutor(max_workers=workers) if workers > 0 else None
    try:
        epoch = 0
        while epochs is None or epoch < epochs:
            order = _epoch_order(len(dataset), shuffle, seed, epoch)
            limit = len(order) - len(order) % batch_size if drop_last else len(order)
            idxs = iter(int(j) for j in order[:limit])
            if executor is None:
                items = (dataset[j] for j in idxs)
            else:
                items = _in_order(executor, dataset, idxs, 2 * workers * batch_size)
            batch: list = []
            for item in items:
                batch.append(item)
                if len(batch) == batch_size:
                    yield np.stack(batch)
                    batch = []
            if batch:
                yield np.stack(batch)
            epoch += 1
    finally:
        if executor is not None:
            executor.shutdown(wait=False, cancel_futures=True)


def _in_order(executor: ThreadPoolExecutor, dataset, idxs: Iterator[int],
              window: int) -> Iterator[np.ndarray]:
    """``dataset[j]`` for each ``j`` of ``idxs``, in order, with at most
    ``window`` items submitted ahead."""
    pending: deque = deque()

    def fill():
        for j in idxs:
            pending.append(executor.submit(dataset.__getitem__, j))
            if len(pending) >= window:
                return

    fill()
    while pending:
        item = pending.popleft().result()
        fill()
        yield item


def prefetch_to_device(
    iterator: Iterator, size: int = 2, device="cuda"
) -> Iterator[torch.Tensor]:
    """The batches of ``iterator`` as tensors on ``device``, ``size`` of them
    copied ahead by a producer thread.  On a CUDA device each batch goes
    through pinned host memory by a ``non_blocking`` copy on a side stream;
    the consumer's stream waits for that copy before the batch is yielded.
    An exception of the iterator reaches the consumer."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    error: list = []
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def producer():
        try:
            for batch in iterator:
                host = torch.from_numpy(np.asarray(batch))
                if stream is None:
                    q.put((host.to(device), None))
                    continue
                with torch.cuda.stream(stream):
                    moved = host.pin_memory().to(device, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(stream)
                q.put((moved, done))
        except BaseException as e:  # handed to the consumer, not swallowed
            error.append(e)
        finally:
            q.put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    while True:
        with span("feed.next", device=False):
            item = q.get()
            if item is sentinel:
                thread.join()
                if error:
                    raise error[0]
                return
            batch, done = item
            if done is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                batch.record_stream(current)
        yield batch


def device_corpus_feed(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    epochs: Optional[int] = None,
    device="cuda",
    workers: int = 4,
    log=None,
) -> Iterator[torch.Tensor]:
    """``(B, max_samples)`` f32 batches gathered on ``device`` from the whole
    corpus, uploaded there once.

    The corpus is decoded up front into one preallocated array by
    ``workers`` threads (``log``, if given, is called with progress
    strings), then copied to ``device``.  Each batch is an ``index_select``
    of the resident corpus by a ``(B,)`` int64 index vector, the only
    per-step transfer (pinned, ``non_blocking`` on a CUDA device).  Epoch
    ``e`` takes ``range(len)`` shuffled by ``default_rng(seed + e)`` and
    drops the last short batch, as :func:`batch_iterator` does.
    """
    device = torch.device(device)
    n = len(dataset)
    first = np.asarray(dataset[0], np.float32)
    corpus = np.empty((n,) + first.shape, np.float32)
    corpus[0] = first
    if log is not None:
        log(f"device feed: decoding {n} clips ({corpus.nbytes / 2**20:.0f} MiB) with "
            f"{max(1, workers)} workers")

    def decode(i):
        corpus[i] = dataset[i]

    with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
        list(ex.map(decode, range(1, n)))
    corpus_dev = torch.from_numpy(corpus).to(device)
    del corpus

    def gen():
        epoch = 0
        while epochs is None or epoch < epochs:
            order = _epoch_order(n, shuffle, seed, epoch)
            for k in range(0, n - n % batch_size, batch_size):
                with span("feed.next", device=False):
                    idx = torch.from_numpy(order[k:k + batch_size].astype(np.int64))
                    if device.type == "cuda":
                        idx = idx.pin_memory().to(device, non_blocking=True)
                    batch = corpus_dev.index_select(0, idx)
                yield batch
            epoch += 1

    return gen()

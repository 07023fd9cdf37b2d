"""The port's input pipeline (``data/pipeline.py``) against the JAX
package's (``data/pipeline.py``) on the CPU: the order of the batches over
two epochs, with and without decode workers, and the device-resident feed's
order, equal to ``batch_iterator(shuffle=True)``'s.  The card's form of the
feed (pinned, ``non_blocking`` index uploads) is a ``gpu`` test in
``tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.data import pipeline as jax_pipeline
from ml_audio_inpainting_torch.data.pipeline import (
    batch_iterator,
    device_corpus_feed,
    prefetch_to_device,
)


class Items:
    """Item ``i`` is a row that names it."""

    def __init__(self, n=10, width=6):
        self.n, self.width = n, width

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full(self.width, float(i), np.float32) + np.arange(self.width, dtype=np.float32)


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_iterator_order_equals_jax(workers, shuffle):
    ds = Items()
    mine = list(batch_iterator(ds, 3, shuffle=shuffle, seed=4, epochs=2, workers=workers))
    ref = list(jax_pipeline.batch_iterator(ds, 3, shuffle=shuffle, seed=4, epochs=2,
                                           workers=workers))
    assert len(mine) == len(ref) == 6  # 10 // 3 batches an epoch, the short one dropped
    for a, b in zip(mine, ref):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    keep = list(batch_iterator(ds, 3, shuffle=shuffle, seed=4, epochs=1, drop_last=False,
                               workers=workers))
    assert [len(b) for b in keep] == [3, 3, 3, 1]


def test_device_corpus_feed_order_equals_batch_iterator():
    ds = Items(n=11)
    feed = device_corpus_feed(ds, 4, seed=2, epochs=2, device="cpu", workers=3)
    got = list(feed)
    want = list(jax_pipeline.batch_iterator(ds, 4, shuffle=True, seed=2, epochs=2))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert isinstance(a, torch.Tensor) and np.array_equal(a.numpy(), b)


def test_prefetch_to_device_keeps_order_and_raises():
    batches = [np.full((2, 3), i, np.float32) for i in range(5)]
    got = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert [int(b[0, 0]) for b in got] == list(range(5))

    def broken():
        yield batches[0]
        raise RuntimeError("decode failed")

    it = prefetch_to_device(broken(), device="cpu")
    assert int(next(it)[0, 0]) == 0
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)

"""The port's corpora (``data/dataset.py``) against the JAX package's
(``data/dataset.py``): the formant corpus bit for bit for the same
``(seed, idx, variant)`` (numpy synthesis, copied with its constants), its
disk-cache file names, and the file corpus through the port's codec.  Each
formant item takes ~0.3 s to synthesise, so few are drawn."""

import hashlib

import numpy as np
import pytest

from ml_audio_inpainting_tpu.data import dataset as jax_dataset
from ml_audio_inpainting_torch.data import dataset
from torch_threads import one_thread  # noqa: F401  (a module fixture)


@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_formant_items_equal_jax_bit_for_bit(variant):
    mine = dataset.FormantSpeechDataset(n_items=8, seed=3, cache=False, variant=variant)
    ref = jax_dataset.FormantSpeechDataset(n_items=8, seed=3, cache=False, variant=variant)
    for idx in (0, 5):
        a, b = mine[idx], ref[idx]
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (80000,)
        assert np.array_equal(a, b), (variant, idx)


def test_pinned_streams_and_determinism():
    """The v1 and v2 streams JAX pins (``tests/test_formant_corpus.py``),
    and items deterministic in ``(seed, idx)``."""
    v1 = dataset.FormantSpeechDataset(n_items=1, cache=False)[0]
    v2 = dataset.FormantSpeechDataset(n_items=1, cache=False, variant="v2")[0]
    assert hashlib.blake2s(v1.tobytes()).hexdigest()[:16] == "478e3c3c324f911f"
    assert hashlib.blake2s(v2.tobytes()).hexdigest()[:16] == "d1c24a71d46cb255"
    a = dataset.FormantSpeechDataset(n_items=3, cache=False, max_len_s=1.0)
    b = dataset.FormantSpeechDataset(n_items=3, cache=False, max_len_s=1.0)
    c = dataset.FormantSpeechDataset(n_items=3, seed=1, cache=False, max_len_s=1.0)
    assert np.array_equal(a[2], b[2]) and not np.array_equal(a[2], c[2])
    with pytest.raises(ValueError):
        dataset.FormantSpeechDataset(variant="v9")


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_disk_cache_names_and_reuse(tmp_path, variant):
    """The cache file is JAX's name, holds the item, and is read back (a
    file written by one package serves the other)."""
    mine = dataset.FormantSpeechDataset(n_items=2, seed=7, max_len_s=0.5, cache=False,
                                        cache_dir=str(tmp_path), variant=variant)
    ref = jax_dataset.FormantSpeechDataset(n_items=2, seed=7, max_len_s=0.5, cache=False,
                                           cache_dir=str(tmp_path), variant=variant)
    assert mine._disk_path(1) == ref._disk_path(1)
    item = mine[1]
    path = mine._disk_path(1)
    assert path.exists() and np.array_equal(np.load(path), item)
    np.save(path, np.full(8000, 0.25, np.float32))  # served from the file, not synthesised
    assert np.array_equal(ref[1], mine[1]) and mine[1][0] == 0.25


def test_audio_file_dataset_matches_jax(tmp_path):
    """Files are listed in sorted order and decoded to the same clips."""
    from ml_audio_inpainting_torch.data.audio_io import save_audio

    rng = np.random.default_rng(0)
    for name in ("b.wav", "a.flac", "sub/c.wav", "skip.txt"):
        path = tmp_path / name
        path.parent.mkdir(exist_ok=True)
        if name.endswith(".txt"):
            path.write_text("x")
        else:
            save_audio((0.3 * rng.standard_normal(12000)).astype(np.float32), str(path), 16000,
                       file_format=path.suffix[1:])
    mine = dataset.AudioFileDataset(tmp_path, max_len_s=0.5)
    ref = jax_dataset.AudioFileDataset(tmp_path, max_len_s=0.5)
    assert [p.name for p in mine.files] == ["a.flac", "b.wav", "c.wav"]
    assert mine.files == ref.files and len(mine) == 3
    for i in range(3):
        assert np.array_equal(mine[i], ref[i]) and mine[i].shape == (8000,)
    assert dataset.list_audio_files(tmp_path, max_files=2) == ref.files[:2]
    with pytest.raises(ValueError):
        dataset.list_audio_files(tmp_path / "missing")

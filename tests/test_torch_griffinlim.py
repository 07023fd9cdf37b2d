"""The port's momentum Griffin-Lim (``ops/griffinlim.py``) and
``ops/reconstruct.py::spectrogram_to_audio`` against the JAX package's on
the CPU, from the same numpy magnitudes and phases, at the two STFT sizes the
repo serves (512/128/512 and 512/192/384).

The magnitudes are those of the JAX package's STFT of two seeded
speech-like 1 s clips with an 80 ms gap each (peak ~1, spectra up to ~60).

Tolerances, on the rebuilt waveform:

* ``init="given"`` (from the gapped phase), 1 to 4 iterations:
  ``atol=1e-5`` (each iteration is an iSTFT and an STFT whose FFTs round in
  other places in the two libraries, ~3e-7 an iteration; 1.3e-6 seen).
* ``init="ones"``, 1 to 4 iterations: ``atol=2e-4``.  From a flat phase the
  quiet bins' directions come from rounding, and the difference roughly
  doubles an iteration (3.1e-6 after one, 8.4e-5 after four seen).
* 64 iterations from the given phase: momentum 0.99 carries each
  iteration's difference into the next and the phase of quiet bins is
  ill-conditioned; ``atol=5e-4`` (7.2e-5 seen).
* float64 magnitudes against JAX under ``jax.enable_x64()``: complex128
  throughout, 64 iterations within ``1e-11`` (6.9e-14 seen).
* ``spectrogram_to_audio`` with a phase or a complex spectrogram: one
  iSTFT, ``atol=2e-6``.
* ``init="random"``: the port draws from a ``torch.Generator`` and JAX from
  ``PRNGKey(0)``, so the bits differ; tested for its range (the start
  phases in [0, 2 pi)) and for being reproducible from the seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.ops.griffinlim import griffinlim as jax_griffinlim
from ml_audio_inpainting_tpu.ops.reconstruct import spectrogram_to_audio as jax_to_audio
from ml_audio_inpainting_tpu.ops.stft import stft as jax_stft
from ml_audio_inpainting_torch.ops.griffinlim import griffinlim
from ml_audio_inpainting_torch.ops.reconstruct import spectrogram_to_audio
from ml_audio_inpainting_torch.ops.stft import istft, stft
from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from torch_threads import one_thread  # noqa: F401  (a module fixture)

SR = 16000
SIZES = {"gan": (512, 128, 512), "cnn": (512, 192, 384)}
FEW_ATOL = {"given": 1e-5, "ones": 2e-4}
MANY_ATOL = 5e-4
F64_ATOL = 1e-11


def _spec(size, dtype=np.float32):
    n_fft, hop, win = SIZES[size]
    audio = speech_like_batch(np.random.default_rng(3), 2, 1.0)
    audio[:, 6000:7280] = 0
    spec = np.asarray(jax_stft(jnp.asarray(audio), n_fft=n_fft, hop_length=hop, win_length=win))
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=win, length=SR)
    return np.abs(spec).astype(dtype), np.angle(spec).astype(dtype), kw


def _both(mag, kw, **opts):
    jopts = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in opts.items()}
    topts = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v) for k, v in opts.items()}
    want = np.asarray(jax_griffinlim(jnp.asarray(mag), **kw, **jopts))
    got = griffinlim(torch.tensor(mag), **kw, **topts).numpy()
    return want, got


@pytest.mark.parametrize("size", ["gan", "cnn"])
@pytest.mark.parametrize("n_iter", [1, 4])
@pytest.mark.parametrize("init", ["given", "ones"])
def test_few_iterations_match_jax(size, n_iter, init):
    mag, ph, kw = _spec(size)
    opts = dict(n_iter=n_iter, init=init)
    if init == "given":
        opts["init_phase"] = ph
    want, got = _both(mag, kw, **opts)
    assert got.shape == want.shape == (2, SR) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=FEW_ATOL[init])


@pytest.mark.parametrize("size", ["gan", "cnn"])
def test_64_iterations_match_jax(size):
    mag, ph, kw = _spec(size)
    want, got = _both(mag, kw, n_iter=64, init="given", init_phase=ph)
    np.testing.assert_allclose(got, want, rtol=0, atol=MANY_ATOL)
    # Griffin-Lim lowers the spectral inconsistency of its start
    n_fft, hop, win = SIZES[size]
    start = istft(torch.polar(torch.tensor(mag), torch.zeros(mag.shape)), n_fft, hop, win,
                  length=SR)

    def inconsistency(x):
        return (stft(x, n_fft, hop, win).abs() - torch.tensor(mag)).norm() / np.linalg.norm(mag)

    assert inconsistency(torch.tensor(got)) < inconsistency(start)


def test_float64_runs_in_complex128_and_matches_jax_x64():
    mag, ph, kw = _spec("gan", np.float64)
    with jax.enable_x64():
        want = np.asarray(jax_griffinlim(jnp.asarray(mag), n_iter=64, init="given",
                                         init_phase=jnp.asarray(ph), **kw))
    got = griffinlim(torch.tensor(mag), n_iter=64, init="given", init_phase=torch.tensor(ph), **kw)
    assert want.dtype == np.float64 and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F64_ATOL)


def test_zeros_is_ones():
    mag, _, kw = _spec("cnn")
    a = griffinlim(torch.tensor(mag), n_iter=2, init="zeros", **kw)
    b = griffinlim(torch.tensor(mag), n_iter=2, init="ones", **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_random_start_is_seeded_and_uniform():
    mag, _, kw = _spec("gan")
    mag_t = torch.tensor(mag)
    a = griffinlim(mag_t, n_iter=3, **kw)  # seed 0 by default
    b = griffinlim(mag_t, n_iter=3, generator=torch.Generator().manual_seed(0), **kw)
    c = griffinlim(mag_t, n_iter=3, generator=torch.Generator().manual_seed(1), **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c) and torch.isfinite(c).all()
    # n_iter=0 is the iSTFT of the start: phases drawn uniformly in [0, 2 pi)
    start = griffinlim(mag_t, n_iter=0, generator=torch.Generator().manual_seed(7), **kw)
    draw = torch.rand(mag.shape, generator=torch.Generator().manual_seed(7)) * (2 * np.pi)
    assert 0 <= draw.min() and draw.max() < 2 * np.pi
    want = istft(torch.polar(mag_t, draw), kw["n_fft"], kw["hop_length"], kw["win_length"],
                 length=SR)
    torch.testing.assert_close(start, want, rtol=0, atol=1e-6)


def test_bad_options_raise():
    mag = torch.ones(1, 257, 10)
    with pytest.raises(ValueError, match="momentum"):
        griffinlim(mag, momentum=1.0)
    with pytest.raises(ValueError, match="init_phase"):
        griffinlim(mag, init="given")
    with pytest.raises(ValueError, match="init must be"):
        griffinlim(mag, init="noise")


@pytest.mark.parametrize("kind", ["complex", "db", "magnitude"])
def test_spectrogram_to_audio_matches_jax(kind):
    """A complex spectrogram through the iSTFT; an all-negative one taken
    for dB and turned into an amplitude, with the given phase; a magnitude
    with the given phase."""
    mag, ph, kw = _spec("gan")
    kw = dict(n_fft=kw["n_fft"], hop_length=kw["hop_length"], win_length=kw["win_length"],
              length=SR)
    if kind == "complex":
        spec = (mag * np.exp(1j * ph)).astype(np.complex64)
        want = jax_to_audio(jnp.asarray(spec), phase_info=True, **kw)
        got = spectrogram_to_audio(torch.tensor(spec), phase_info=True, **kw)
    else:
        spec = 20 * np.log10(mag + 1e-3) - 80.0 if kind == "db" else mag
        assert kind != "db" or spec.max() < 0
        want = jax_to_audio(jnp.asarray(spec), phase=jnp.asarray(ph), **kw)
        got = spectrogram_to_audio(torch.tensor(spec), phase=torch.tensor(ph), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


def test_spectrogram_to_audio_without_phase_is_griffinlim():
    mag, _, kw = _spec("cnn")
    got = spectrogram_to_audio(torch.tensor(mag), n_iter=3, generator=torch.Generator().manual_seed(2),
                               **kw)
    want = griffinlim(torch.tensor(mag), n_iter=3, generator=torch.Generator().manual_seed(2), **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)

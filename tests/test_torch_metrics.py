"""The port's quality metrics (``train/metrics.py``: ``snr``, ``gap_sdr``,
``log_spectral_distance``, ``fwseg_snr``, ``spectral_convergence``) and the
STFT helpers ``magnitude`` and ``num_frames`` (``ops/stft.py``) against the
JAX package's on the CPU, on the same seeded numpy batches.

Tolerances: the dB metrics within ``1e-3`` dB (f32 sums of up to 80 000
terms and the two FFTs' rounding; up to 1.3e-5 seen); spectral convergence
``rtol=1e-5``; ``magnitude`` ``rtol=1e-6`` (the two FFTs' rounding is
compared on the same complex input, so only ``abs`` and ``pow`` differ);
``num_frames`` exactly.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.train import metrics as jm
from ml_audio_inpainting_torch.ops import stft as port_stft
from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from ml_audio_inpainting_torch.train import metrics as tm
from torch_threads import one_thread  # noqa: F401  (a module fixture)

# The JAX package's ``ops`` exports a function ``stft`` under the module's name.
jax_stft = importlib.import_module("ml_audio_inpainting_tpu.ops.stft")
DB_ATOL = 1e-3


def _batch(shape, seed, seconds=1.0):
    """Speech-like references and estimates ``shape + (T,)``: noisy,
    gap-zeroed, and one row equal to its reference outside a gap."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    ref = speech_like_batch(rng, n, seconds)
    est = ref + 0.05 * rng.standard_normal(ref.shape).astype(np.float32)
    T = ref.shape[-1]
    gap = np.zeros_like(ref)
    for i in range(n):
        s = int(rng.integers(0, T - 2000))
        gap[i, s : s + int(rng.integers(100, 2000))] = 1.0
    est[0] = np.where(gap[0] > 0, est[0], ref[0])  # equal to the reference outside the gap
    if n > 1:
        est[1] = ref[1] * (1.0 - gap[1])  # the gap zeroed
    return tuple(a.reshape(*shape, T) for a in (ref, est, gap))


def _both(jax_fn, port_fn, *arrays, **kw):
    want = np.asarray(jax_fn(*(jnp.asarray(a) for a in arrays), **kw))
    got = port_fn(*(torch.tensor(a) for a in arrays), **kw)
    assert got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("shape", [(4,), (2, 3)], ids=["batch", "two_axes"])
@pytest.mark.parametrize("name", ["snr", "log_spectral_distance", "fwseg_snr"])
def test_waveform_metric_matches_jax(name, shape):
    ref, est, _ = _batch(shape, seed=len(shape))
    got, want = _both(getattr(jm, name), getattr(tm, name), ref, est)
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=DB_ATOL)


@pytest.mark.parametrize("shape", [(4,), (2, 3)], ids=["batch", "two_axes"])
def test_gap_sdr_matches_jax(shape):
    ref, est, gap = _batch(shape, seed=7)
    got, want = _both(jm.gap_sdr, tm.gap_sdr, ref, est, gap)
    assert got.shape == shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=DB_ATOL)
    # The zeroed gap's SDR is 0 dB; outside the gap the error does not count.
    zeroed = got.reshape(-1)[1]
    assert abs(zeroed) < 1e-4


def test_identical_signals_give_the_eps_limits():
    ref, _, gap = _batch((2,), seed=3)
    got, want = _both(jm.snr, tm.snr, ref, ref)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    got, want = _both(jm.gap_sdr, tm.gap_sdr, ref, ref, gap)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    got, want = _both(jm.fwseg_snr, tm.fwseg_snr, ref, ref)
    np.testing.assert_allclose(got, want, rtol=0, atol=DB_ATOL)
    got, want = _both(jm.log_spectral_distance, tm.log_spectral_distance, ref, ref)
    assert (got == 0).all() and (want == 0).all()


@pytest.mark.parametrize("kw", [{}, {"n_fft": 1024, "hop_length": 256}], ids=["512", "1024"])
def test_spectral_options_match_jax(kw):
    ref, est, _ = _batch((3,), seed=11)
    for name in ("log_spectral_distance", "fwseg_snr"):
        got, want = _both(getattr(jm, name), getattr(tm, name), ref, est, **kw)
        np.testing.assert_allclose(got, want, rtol=0, atol=DB_ATOL)


def test_spectral_convergence_matches_jax():
    ref, est, _ = _batch((3,), seed=5)
    mr = np.abs(np.asarray(jax_stft.stft(jnp.asarray(ref)))).astype(np.float32)
    me = np.abs(np.asarray(jax_stft.stft(jnp.asarray(est)))).astype(np.float32)
    got, want = _both(jm.spectral_convergence, tm.spectral_convergence, mr, me)
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("power", [1.0, 2.0, 0.5])
def test_magnitude_matches_jax(power):
    rng = np.random.default_rng(9)
    spec = (rng.standard_normal((2, 257, 30)) + 1j * rng.standard_normal((2, 257, 30)))
    spec = spec.astype(np.complex64)
    want = np.asarray(jax_stft.magnitude(jnp.asarray(spec), power=power))
    got = port_stft.magnitude(torch.tensor(spec), power=power).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("n,hop,n_fft,center", [(80000, 128, 512, True), (80000, 192, 512, False),
                                                (16000, 192, 384, True), (513, 128, 512, False),
                                                (0, 128, 512, True)])
def test_num_frames_matches_jax(n, hop, n_fft, center):
    assert port_stft.num_frames(n, hop, n_fft, center) == jax_stft.num_frames(n, hop, n_fft, center)
    if center:
        assert port_stft.num_frames(n, hop, n_fft) == port_stft.stft(
            torch.zeros(n), n_fft=n_fft, hop_length=hop).shape[-1]

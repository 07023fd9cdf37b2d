"""The port's PSM score (``train/auditory.py``) against the JAX package's on
the CPU, on the same seeded numpy clips.

Tolerances: the gammatone bank's frequency response bit for bit (the same
numpy on the host); the filterbank output and ``internal_representation``
within ``rtol=1e-4`` of their largest value (f32 FFTs of up to 131 072
points in another library: 4.7e-7 seen on the representation); ``psm_score``
within ``1e-5`` (3.6e-7 seen).  One case runs 5 s clips, where the
convolution's FFT is 131 072 points long.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.train import auditory as ja
from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from ml_audio_inpainting_torch.train import auditory as ta
from torch_threads import one_thread  # noqa: F401  (a module fixture)

PSM_ATOL = 1e-5
REP_RTOL = 1e-4


def _pair(n, seconds, seed, noise=0.05):
    rng = np.random.default_rng(seed)
    ref = speech_like_batch(rng, n, seconds)
    test = ref + noise * rng.standard_normal(ref.shape).astype(np.float32)
    test[0, 4000:5280] = 0.0  # a zeroed gap
    return ref, test


@pytest.mark.parametrize("args", [(16000, 30, 80.0, 7000.0, 2048, 32768),
                                  (16000, 30, 80.0, 7000.0, 2048, 131072),
                                  (8000, 12, 100.0, 3500.0, 512, 4096)],
                         ids=["1s", "5s", "small"])
def test_gammatone_response_is_bit_for_bit(args):
    want = ja._gammatone_kernel_fft(*args)
    got = ta._gammatone_kernel_fft(*args)
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_array_equal(got, want)
    on_device = ta._gammatone_kernel_on(torch.device("cpu"), *args)
    assert on_device is ta._gammatone_kernel_on(torch.device("cpu"), *args)  # copied once
    np.testing.assert_array_equal(on_device.numpy(), want)


def test_filterbank_matches_jax():
    ref, _ = _pair(2, 0.5, seed=1)
    want = np.asarray(ja.gammatone_filterbank(jnp.asarray(ref)))
    got = ta.gammatone_filterbank(torch.tensor(ref)).numpy()
    assert got.shape == want.shape == (2, 30, 8000)
    np.testing.assert_allclose(got, want, rtol=0, atol=REP_RTOL * np.abs(want).max())


@pytest.mark.parametrize("shape", [(2,), (2, 2)], ids=["batch", "two_axes"])
def test_internal_representation_matches_jax(shape):
    ref, _ = _pair(int(np.prod(shape)), 1.0, seed=2)
    ref = ref.reshape(*shape, -1)
    want = np.asarray(ja.internal_representation(jnp.asarray(ref)))
    got = ta.internal_representation(torch.tensor(ref)).numpy()
    assert got.shape == want.shape == (*shape, 30, 100)
    np.testing.assert_allclose(got, want, rtol=0, atol=REP_RTOL * np.abs(want).max())


@pytest.mark.parametrize("seconds,noise", [(1.0, 0.05), (1.0, 0.5), (5.0, 0.05)],
                         ids=["1s", "1s-loud-noise", "5s"])
def test_psm_matches_jax(seconds, noise):
    ref, test = _pair(3, seconds, seed=3, noise=noise)
    want = np.asarray(ja.psm_score(jnp.asarray(ref), jnp.asarray(test)))
    got = ta.psm_score(torch.tensor(ref), torch.tensor(test)).numpy()
    assert got.shape == (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=PSM_ATOL)


def test_psm_of_a_clip_against_itself_is_one():
    ref, _ = _pair(2, 1.0, seed=4)
    got = ta.psm_score(torch.tensor(ref), torch.tensor(ref)).numpy()
    np.testing.assert_allclose(got, 1.0, rtol=0, atol=1e-6)

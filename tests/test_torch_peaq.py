"""The port's PEAQ-class ODG (``train/peaq.py``) against the JAX package's
on the CPU, on the same seeded numpy clips.

Tolerances: the ear model's host constants bit for bit (the same numpy);
``excitation_patterns`` within ``rtol=1e-4`` a value (f32 FFTs, the band
grouping's matrix product and ``pow`` in another library: 1.2e-6 seen);
``nmr_total`` within ``1e-3`` dB (3.8e-6 seen); ``odg_score`` within
``1e-4`` (2.4e-7 seen).  The calibration's three anchors come back: ODG
-1.73, -3.80 and -3.91 at -25.86, 2.646 and 14.116 dB total NMR, within
``1e-5`` (f32 logits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.train import peaq as jp
from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from ml_audio_inpainting_torch.train import peaq as tp
from torch_threads import one_thread  # noqa: F401  (a module fixture)

EP_RTOL, NMR_ATOL, ODG_ATOL = 1e-4, 1e-3, 1e-4


def _pair(n, seconds, seed, noise):
    rng = np.random.default_rng(seed)
    ref = speech_like_batch(rng, n, seconds)
    test = ref + noise * rng.standard_normal(ref.shape).astype(np.float32)
    test[0, 6000:7280] = 0.0  # a zeroed gap
    return ref, test


def test_ear_constants_are_bit_for_bit():
    for want, got in zip(jp._ear_constants(16000), tp._ear_constants(16000)):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)
    assert tp.ODG_MAPPING == jp.ODG_MAPPING
    assert tp._ODG_ANCHORS == jp._ODG_ANCHORS


@pytest.mark.parametrize("shape,seconds", [((2,), 1.0), ((2, 2), 0.5), ((1,), 5.0)],
                         ids=["1s", "two_axes", "5s"])
def test_excitation_patterns_match_jax(shape, seconds):
    ref, _ = _pair(int(np.prod(shape)), seconds, seed=1, noise=0.0)
    ref = ref.reshape(*shape, -1)
    want = np.asarray(jp.excitation_patterns(jnp.asarray(ref)))
    got = tp.excitation_patterns(torch.tensor(ref)).numpy()
    assert got.shape == want.shape and got.shape[-1] == 86
    np.testing.assert_allclose(got, want, rtol=EP_RTOL)


@pytest.mark.parametrize("noise", [0.0, 1e-3, 0.05, 0.5])
def test_nmr_and_odg_match_jax(noise):
    ref, test = _pair(3, 1.0, seed=2, noise=noise)
    r, t = jnp.asarray(ref), jnp.asarray(test)
    want_nmr, want_odg = np.asarray(jp.nmr_total(r, t)), np.asarray(jp.odg_score(r, t))
    got_nmr = tp.nmr_total(torch.tensor(ref), torch.tensor(test)).numpy()
    got_odg = tp.odg_score(torch.tensor(ref), torch.tensor(test)).numpy()
    assert got_nmr.shape == got_odg.shape == (3,)
    np.testing.assert_allclose(got_nmr, want_nmr, rtol=0, atol=NMR_ATOL)
    np.testing.assert_allclose(got_odg, want_odg, rtol=0, atol=ODG_ATOL)
    assert ((got_odg <= 0) & (got_odg >= -4)).all()


def test_odg_on_5s_clips_matches_jax():
    ref, test = _pair(2, 5.0, seed=3, noise=0.02)
    want = np.asarray(jp.odg_score(jnp.asarray(ref), jnp.asarray(test)))
    got = tp.odg_score(torch.tensor(ref), torch.tensor(test)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ODG_ATOL)


def test_anchors_are_reproduced():
    nmr = torch.tensor([a[0] for a in tp._ODG_ANCHORS])
    got = tp._odg_of_nmr(nmr).numpy()
    np.testing.assert_allclose(got, [a[1] for a in tp._ODG_ANCHORS], rtol=0, atol=1e-5)
    assert np.diff(tp._odg_of_nmr(torch.linspace(-60.0, 40.0, 101)).numpy()).max() < 0


@pytest.mark.parametrize("n", [0, 1000, 2047])
def test_short_input_raises(n):
    x = torch.zeros(2, n)
    with pytest.raises(ValueError, match="too short"):
        tp.nmr_total(x, x)
    with pytest.raises(ValueError, match="too short"):
        tp.excitation_patterns(x)


def test_2048_samples_make_one_frame():
    x = torch.tensor(speech_like_batch(np.random.default_rng(4), 1, 2048 / 16000))
    assert tp.excitation_patterns(x).shape == (1, 1, 86)

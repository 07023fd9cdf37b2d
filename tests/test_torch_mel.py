"""The port's mel module (``ops/mel.py``) and dB helpers
(``ops/masking.py::amplitude_to_db``, ``db_to_amplitude``, ``power_to_db``)
against the JAX package's ``ops/mel.py`` and ``ops/masking.py`` on the CPU,
from the same numpy inputs.

Tolerances:

* ``hz_to_mel``, ``mel_to_hz``, ``mel_filterbank``: exactly (the same
  numpy float64 code on the host in both packages).
* ``mel_spectrogram`` (n_fft 512 and 2048, power 1 and 2, of seeded
  speech-like 1 s clips): ``1e-5`` of the largest value of each
  spectrogram (two FFTs' f32 rounding through a sum over 257 or 1025 bins;
  3.4e-7 seen).
* ``mel_to_audio``: the linear magnitude it hands to Griffin-Lim (the
  filterbank's pseudo-inverse, then the square root of a power
  spectrogram), within ``2e-6`` of its largest value (~76; a product in
  f32 with cancellation over 64 mels; 1.7e-7 seen); Griffin-Lim
  starts from a random phase, whose bits differ between the packages
  (``tests/test_torch_griffinlim.py``).
* dB helpers: ``atol=1e-4`` dB on values of -80..+40 (one f32 ulp of a
  log10 times 10; 1.5e-5 seen) and ``rtol=1e-6`` back to amplitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.ops import masking as jax_masking
from ml_audio_inpainting_tpu.ops import mel as jax_mel
from ml_audio_inpainting_torch.ops import masking, mel
from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from torch_threads import one_thread  # noqa: F401  (a module fixture)

SR = 16000


def _audio(n=2):
    return speech_like_batch(np.random.default_rng(9), n, 1.0)


@pytest.mark.parametrize("htk", [False, True])
def test_mel_scale_matches_jax(htk):
    hz = np.concatenate([np.linspace(0, 8000, 97), [999.9, 1000.0, 1000.1]])
    np.testing.assert_array_equal(mel.hz_to_mel(hz, htk), jax_mel.hz_to_mel(hz, htk))
    m = mel.hz_to_mel(hz, htk)
    np.testing.assert_array_equal(mel.mel_to_hz(m, htk), jax_mel.mel_to_hz(m, htk))
    np.testing.assert_allclose(mel.mel_to_hz(m, htk), hz, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("n_fft,n_mels,fmin,fmax,htk,norm", [
    (512, 128, 0.0, None, False, "slaney"),
    (2048, 128, 0.0, None, False, "slaney"),
    (512, 40, 50.0, 7000.0, True, None),
])
def test_mel_filterbank_matches_jax(n_fft, n_mels, fmin, fmax, htk, norm):
    got = mel.mel_filterbank(SR, n_fft, n_mels, fmin, fmax, htk, norm, dtype=np.float64)
    want = jax_mel.mel_filterbank(SR, n_fft, n_mels, fmin, fmax, htk, norm, dtype=np.float64)
    assert got.shape == (n_mels, n_fft // 2 + 1)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="norm"):
        mel.mel_filterbank(SR, n_fft, norm="l2")


@pytest.mark.parametrize("n_fft,hop,power", [(512, 128, 2.0), (2048, 512, 2.0), (512, 192, 1.0)])
def test_mel_spectrogram_matches_jax(n_fft, hop, power):
    audio = _audio()
    got = mel.mel_spectrogram(torch.tensor(audio), SR, n_fft, hop, 128, power=power).numpy()
    want = np.asarray(jax_mel.mel_spectrogram(jnp.asarray(audio), SR, n_fft, hop, 128,
                                              power=power))
    assert got.shape == want.shape == (2, 128, 1 + SR // hop) and got.dtype == np.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_mel_to_audio_hands_griffinlim_the_same_magnitude(monkeypatch):
    """Both modules' Griffin-Lim replaced by a spy: the linear magnitude and
    the STFT options handed to it."""
    seen = {}

    def spy(key):
        def fn(linear, **kw):
            seen[key] = (np.asarray(linear), {k: v for k, v in kw.items() if k != "key"
                                              and k != "generator"})
            return linear
        return fn

    monkeypatch.setattr(jax_mel, "griffinlim", spy("jax"))
    monkeypatch.setattr(mel, "griffinlim", spy("port"))
    audio = _audio()
    spec = np.asarray(jax_mel.mel_spectrogram(jnp.asarray(audio), SR, 512, 128, 64))
    jax_mel.mel_to_audio(jnp.asarray(spec), SR, 512, 128, n_iter=5, n_mels=64)
    mel.mel_to_audio(torch.tensor(spec), SR, 512, 128, n_iter=5, n_mels=64)
    (got, got_kw), (want, want_kw) = seen["port"], seen["jax"]
    assert got_kw == want_kw == dict(n_iter=5, n_fft=512, hop_length=128)
    assert got.shape == (2, 257, 126) and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * want.max())


def test_mel_to_audio_runs_griffinlim_from_a_seed():
    audio = torch.tensor(_audio(1))
    spec = mel.mel_spectrogram(audio, SR, 512, 128, 64)
    a = mel.mel_to_audio(spec, SR, 512, 128, n_iter=4, n_mels=64,
                         generator=torch.Generator().manual_seed(0))
    b = mel.mel_to_audio(spec, SR, 512, 128, n_iter=4, n_mels=64,
                         generator=torch.Generator().manual_seed(0))
    assert a.shape == (1, 128 * (spec.shape[-1] - 1)) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("top_db", [80.0, None, 20.0])
def test_db_helpers_match_jax(top_db):
    rng = np.random.default_rng(2)
    mag = (10.0 ** rng.uniform(-6, 2, (2, 257, 50))).astype(np.float32)
    mag[0, :3, :3] = 0.0
    got = masking.amplitude_to_db(torch.tensor(mag), ref=2.0, top_db=top_db).numpy()
    want = np.asarray(jax_masking.amplitude_to_db(jnp.asarray(mag), ref=2.0, top_db=top_db))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    power = mag ** 2
    got_p = masking.power_to_db(torch.tensor(power), top_db=top_db).numpy()
    want_p = np.asarray(jax_masking.power_to_db(jnp.asarray(power), top_db=top_db))
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-4)
    if top_db is not None:
        assert got.min() >= got.max() - top_db - 1e-4
    db = rng.uniform(-80, 40, (3, 100)).astype(np.float32)
    np.testing.assert_allclose(masking.db_to_amplitude(torch.tensor(db), ref=0.5).numpy(),
                               np.asarray(jax_masking.db_to_amplitude(jnp.asarray(db), ref=0.5)),
                               rtol=1e-6, atol=0)
    loud = masking.amplitude_to_db(torch.tensor(mag[mag > 1e-2]), top_db=None)
    np.testing.assert_allclose(masking.db_to_amplitude(loud).numpy(), mag[mag > 1e-2], rtol=1e-5)

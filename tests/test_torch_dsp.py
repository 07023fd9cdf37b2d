"""The port's DSP core (``ml_audio_inpainting_torch.ops``: gap masks,
STFT/iSTFT, log10 normalisation) against the JAX package on the CPU.

Tolerances: the gap mask is exact.  STFT/iSTFT compare f32 FFTs of two
libraries (pocketfft in both, but other plans and summation orders):
``atol=1e-4`` on spectra whose bins reach ~1e2 (window sum ~192 for unit
signals), ``atol=1e-5`` on waveforms of peak 1.  ``log10_norm`` and
``log10_denorm`` are elementwise: ``rtol=1e-6``.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ml_audio_inpainting_tpu.ops.stft  # noqa: F401
from ml_audio_inpainting_tpu.ops import gaps as jgaps
from ml_audio_inpainting_tpu.ops import masking as jmasking
from ml_audio_inpainting_torch.ops import gaps, masking
from ml_audio_inpainting_torch.ops import stft as tstft

# The JAX ``ops`` package re-exports a function named ``stft`` over the module.
jstft = sys.modules["ml_audio_inpainting_tpu.ops.stft"]

PROFILES = {
    "cnn_512_192_384": dict(n_fft=512, hop_length=192, win_length=384),
    "gan_512_128_512": dict(n_fft=512, hop_length=128, win_length=512),
}
SHAPES_5S = {"cnn_512_192_384": (257, 417), "gan_512_128_512": (257, 626)}
SIGNALS = ["sine", "sine_combo", "chirp", "impulse_train", "noise"]


@pytest.mark.parametrize(
    "start,length", [(0, 0), (0, 100), (32000, 1280), (79990, 100), (500, 79500)]
)
def test_gap_mask_matches_jax(start, length):
    n = 80000
    want = np.asarray(jgaps.gap_mask(n, jnp.asarray(start), jnp.asarray(length)))
    got = gaps.gap_mask(n, torch.tensor(start), torch.tensor(length)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gap_mask_batched():
    rng = np.random.default_rng(3)
    starts = rng.integers(0, 15000, size=6)
    lens = rng.integers(0, 3000, size=6)
    got = gaps.gap_mask(16000, torch.as_tensor(starts), torch.as_tensor(lens)).numpy()
    assert got.shape == (6, 16000) and got.dtype == np.float32
    for b in range(6):
        want = np.asarray(jgaps.gap_mask(16000, jnp.asarray(starts[b]), jnp.asarray(lens[b])))
        np.testing.assert_array_equal(got[b], want)


@pytest.mark.parametrize("win_length", [384, 512])
def test_window_and_pad_center(win_length):
    want = np.asarray(jstft.pad_center(jstft.get_window("hann", win_length), 512))
    got = tstft.pad_center(tstft.get_window("hann", win_length), 512).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("window", ["hamming", "blackman", "ones"])
def test_other_windows_raise(window):
    """The serving path uses only Hann; the port has no other window yet."""
    with pytest.raises(ValueError, match="only 'hann'"):
        tstft.get_window(window, 384)


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("signal", SIGNALS)
def test_stft_matches_jax(test_signals, profile, signal):
    y = test_signals[signal]
    kw = PROFILES[profile]
    want = np.asarray(jstft.stft(jnp.asarray(y), **kw))
    got = tstft.stft(torch.tensor(y), **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_stft_istft_speech_batch(speech_like, profile):
    """5 s clips: the production shapes (257x417 and 257x626), a batch of 2,
    the iSTFT of one spectrum through both packages, and the round trip."""
    kw = PROFILES[profile]
    y = np.stack([speech_like, 0.5 * speech_like[::-1].copy()])
    spec_j = np.asarray(jstft.stft(jnp.asarray(y), **kw))
    spec_t = tstft.stft(torch.tensor(y), **kw)
    assert tuple(spec_t.shape) == (2,) + SHAPES_5S[profile]
    np.testing.assert_allclose(spec_t.numpy(), spec_j, rtol=0, atol=1e-4)

    want = np.asarray(jstft.istft(jnp.asarray(spec_j), length=y.shape[-1], **kw))
    got = tstft.istft(torch.tensor(spec_j), length=y.shape[-1], **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tstft.istft(spec_t, length=y.shape[-1], **kw).numpy(), y, atol=1e-5)


def _window_sum_square(kw, n_frames, length):
    """The iSTFT's window sum-square, centre-trimmed and padded to ``length``."""
    win = np.asarray(jstft.pad_center(jstft.get_window("hann", kw["win_length"]), kw["n_fft"]))
    wss = np.zeros(kw["n_fft"] + kw["hop_length"] * (n_frames - 1))
    for k in range(n_frames):
        wss[k * kw["hop_length"] : k * kw["hop_length"] + kw["n_fft"]] += win**2
    wss = wss[kw["n_fft"] // 2 :][:length]
    return np.pad(wss, (0, length - len(wss)))


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("length", [None, 15000, 16000, 17000])
def test_istft_lengths_match_jax(test_signals, profile, length):
    """Trim to ``length``, zero-pad past the signal, and no ``length``.

    Past the signal's end the window sum-square falls towards 0 (to 4e-9
    before the padded tail), and dividing by it scales the two FFTs' f32
    rounding up by as much: samples with a sum-square below 1e-3 are
    compared after multiplying it back, the rest directly."""
    kw = PROFILES[profile]
    spec = np.asarray(jstft.stft(jnp.asarray(test_signals["chirp"]), **kw))
    want = np.asarray(jstft.istft(jnp.asarray(spec), length=length, **kw))
    got = tstft.istft(torch.tensor(spec), length=length, **kw).numpy()
    assert got.shape == want.shape
    wss = _window_sum_square(kw, spec.shape[-1], want.shape[-1])
    ok = wss >= 1e-3
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got * wss, want * wss, rtol=0, atol=1e-5)


def test_istft_zero_window_sum_is_not_divided():
    """A hop longer than ``n_fft`` leaves samples no frame covers: the window
    sum-square there is 0 and the JAX iSTFT leaves the sum (0) as is, where
    ``torch.istft`` would raise on the NOLA check.  Elsewhere the comparison
    is as in ``test_istft_lengths_match_jax``."""
    kw = dict(n_fft=64, hop_length=96, win_length=64, center=False)
    rng = np.random.default_rng(5)
    spec = (rng.standard_normal((33, 7)) + 1j * rng.standard_normal((33, 7))).astype(np.complex64)
    want = np.asarray(jstft.istft(jnp.asarray(spec), **kw))
    got = tstft.istft(torch.tensor(spec), **kw).numpy()
    win = np.asarray(jstft.get_window("hann", 64))
    wss = np.zeros(64 + 96 * 6)
    for k in range(7):
        wss[k * 96 : k * 96 + 64] += win**2
    assert got.shape == want.shape == wss.shape and (wss == 0).sum() >= 6 * 32
    np.testing.assert_array_equal(got[wss == 0], 0.0)
    np.testing.assert_array_equal(want[wss == 0], 0.0)
    ok = wss >= 1e-3
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got * wss, want * wss, rtol=0, atol=1e-5)


def test_log10_norm_denorm_match_jax():
    rng = np.random.default_rng(7)
    mag = np.abs(rng.standard_normal((3, 257, 40)) * 10).astype(np.float32)
    mag[0, :5] = 0.0
    want = np.asarray(jmasking.log10_norm(jnp.asarray(mag)))
    got = masking.log10_norm(torch.tensor(mag)).numpy()
    # Where mag is near 1, |log10(mag)| falls to ~1e-4 and below (6.7e-5 in
    # this input), and one f32 ulp of either library's log there is far above
    # 1e-6 relative; which way each rounds depends on the host's CPU.  So an
    # absolute floor of 4 f32 ulps at 1.0 (4.8e-7) beside the relative bound.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=4 * np.finfo(np.float32).eps)
    np.testing.assert_allclose(
        masking.log10_denorm(torch.tensor(want)).numpy(),
        np.asarray(jmasking.log10_denorm(jnp.asarray(want))),
        rtol=1e-6,
    )
    assert masking.LOG10_EPS == jmasking.LOG10_EPS

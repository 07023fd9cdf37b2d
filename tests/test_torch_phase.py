"""The port's phase-vocoder gap-phase extrapolation (``ops/phase.py``:
``princarg``, ``window_clear_frame_mask``, ``extrapolate_phase``) against the
JAX package's ``ops/phase.py`` on the CPU, from the same numpy inputs, at the
two STFT sizes the repo serves (GAN 512/128/512, CNN+BiLSTM 512/192/384).

The inputs are the phases of the JAX package's STFT of seeded speech-like
1 s clips with gaps applied: at the clip's start, at its end, one frame
long, 0.5 s long, and two gaps with a valid run of one trustworthy frame
between them (the ``l_ok``/``r_ok`` fallbacks to the nominal advance).

Tolerances:

* ``window_clear_frame_mask``: exactly (integer sums).
* ``princarg``: ``atol=1e-6`` rad (one f32 ulp of the division at |x| ~ 10;
  0 seen), and the same round-half-to-even choice on exact halves.
* ``extrapolate_phase``: trustworthy frames pass through exactly; the
  extrapolated ones compared on the unit circle, ``|e^{i a} - e^{i b}|``, so
  that an angle near pi that wraps to -pi in the other package counts as
  equal.  ``atol=2e-5``: the phase is carried ``steps * dphi`` across the
  gap, up to 62 frames for 0.5 s at hop 128, and one f32 ulp of ``dphi``
  (values up to ~pi) or of the sum (up to ~200 rad) becomes ~1.5e-5 rad
  there (2.9e-6 seen, on the clip with two close gaps; 3.6e-7 at 0.5 s).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.ops import phase as jax_phase
from ml_audio_inpainting_tpu.ops.stft import stft as jax_stft
from ml_audio_inpainting_torch.ops import phase
from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from torch_threads import one_thread  # noqa: F401  (a module fixture)

SR = 16000
SIZES = {"gan": (512, 128, 512), "cnn": (512, 192, 384)}
EXT_ATOL = 2e-5


def _masks(hop: int) -> np.ndarray:
    """(5, SR) 1 = valid sample masks: a gap at the clip's start, one into
    its end, one a frame long, one of 0.5 s, and two gaps whose space holds
    exactly one window-clear frame (so the run between them is one frame)."""
    m = np.ones((5, SR), np.float32)
    m[0, :900] = 0
    m[1, SR - 1300:] = 0
    m[2, 5000:5000 + hop] = 0
    m[3, 4000:4000 + SR // 2] = 0
    # window-clear frame t needs [t hop - 256, t hop + 256) free: with the gap
    # ending at 40 hop - 256 and the next starting at 40 hop + 256, frame 40
    # alone is clear between them.
    m[4, 30 * hop:40 * hop - 256] = 0
    m[4, 40 * hop + 256:50 * hop] = 0
    return m


def _phases(n_fft, hop, win, masks, seed=0):
    audio = speech_like_batch(np.random.default_rng(seed), len(masks), 1.0)
    spec = np.asarray(jax_stft(jnp.asarray(audio * masks), n_fft=n_fft, hop_length=hop,
                               win_length=win))
    return spec


def test_princarg_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-40, 40, 2000), np.pi * np.arange(-9, 10)]).astype(np.float32)
    got = phase.princarg(torch.tensor(x)).numpy()
    want = np.asarray(jax_phase.princarg(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(np.abs(got) <= np.pi + 1e-5)
    halves = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.tensor(halves)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(halves))))


@pytest.mark.parametrize("size", ["gan", "cnn"])
@pytest.mark.parametrize("win_override", [None, 511])
def test_window_clear_frame_mask_matches_jax(size, win_override):
    n_fft, hop, win = SIZES[size]
    win = win_override or win
    masks = _masks(hop)
    n = 1 + SR // hop
    got = phase.window_clear_frame_mask(torch.tensor(masks), n, hop, n_fft, win_length=win)
    want = jax_phase.window_clear_frame_mask(jnp.asarray(masks), n, hop, n_fft, win_length=win)
    assert got.dtype == torch.float32 and got.shape == (5, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # stricter than the frames' centres: every frame whose centre is in a gap is untrusted
    centre_in_gap = masks[:, np.minimum(np.arange(n) * hop, SR - 1)] < 0.5
    assert not got.numpy()[centre_in_gap].any()


@pytest.mark.parametrize("size", ["gan", "cnn"])
def test_extrapolate_phase_matches_jax(size):
    n_fft, hop, win = SIZES[size]
    masks = _masks(hop)
    spec = _phases(n_fft, hop, win, masks)
    ph = np.angle(spec).astype(np.float32)
    n = spec.shape[-1]
    trust = np.asarray(jax_phase.window_clear_frame_mask(jnp.asarray(masks), n, hop, n_fft,
                                                         win_length=win))
    want = np.asarray(jax_phase.extrapolate_phase(jnp.asarray(ph), jnp.asarray(trust), hop, n_fft))
    got = phase.extrapolate_phase(torch.tensor(ph), torch.tensor(trust), hop, n_fft).numpy()
    assert got.shape == ph.shape and got.dtype == np.float32
    kept = np.broadcast_to(trust[:, None, :] > 0.5, ph.shape)
    np.testing.assert_array_equal(got[kept], ph[kept])
    assert (~kept).any(axis=(1, 2)).all()  # every clip has frames to extrapolate
    err = np.abs(np.exp(1j * got.astype(np.float64)) - np.exp(1j * want.astype(np.float64)))
    assert err.max() <= EXT_ATOL, err.max()


def test_one_frame_valid_run_falls_back_to_the_nominal_advance():
    """Between two gaps one trustworthy frame: neither side can measure an
    advance (its neighbour is untrusted), so both extrapolate with omega,
    as the JAX function does."""
    n_fft, hop, win = SIZES["gan"]
    masks = _masks(hop)[4:5]
    n = 1 + SR // hop
    trust = phase.window_clear_frame_mask(torch.tensor(masks), n, hop, n_fft, win_length=win)
    assert trust[0, 39].item() == 0 and trust[0, 40].item() == 1 and trust[0, 41].item() == 0
    ph = torch.tensor(np.angle(_phases(n_fft, hop, win, masks)).astype(np.float32))
    out = phase.extrapolate_phase(ph, trust, hop, n_fft)
    omega = 2 * np.pi * hop / n_fft * np.arange(257)
    # frame 41 is right of the single valid frame 40; its right side is the
    # next trusted frame after the second gap
    rv = int(np.nonzero(trust[0].numpy()[41:])[0][0]) + 41
    w_l = np.sin(0.5 * np.pi * (rv - 41) / (rv - 40)) ** 2
    right_ok = trust[0, rv + 1].item() == 1
    dphi_r = (np.angle(np.exp(1j * (ph[0, :, rv + 1] - ph[0, :, rv]).numpy().astype(np.float64)
                              - 1j * omega)) + omega) if right_ok else omega
    ext_l = ph[0, :, 40].numpy() + 1 * omega
    ext_r = ph[0, :, rv].numpy() - (rv - 41) * dphi_r
    want = np.angle(w_l * np.exp(1j * ext_l) + (1 - w_l) * np.exp(1j * ext_r))
    err = np.abs(np.exp(1j * out[0, :, 41].numpy()) - np.exp(1j * want))
    # This rebuild is in f64; the port carries advances of up to omega[-1]
    # (~400 rad a hop) in f32 over rv - 40 frames: a few ulps of that a frame.
    atol = 4 * (rv - 40) * float(np.spacing(np.float32(omega[-1] + np.pi)))
    assert err.max() <= atol, (err.max(), atol)


@pytest.mark.parametrize("size", ["gan", "cnn"])
def test_zero_bin_rule_leaves_the_extrapolation_unchanged(size):
    """Queue C item 4: frames wholly inside a gap have exactly zero bins,
    whose angle is pi where the FFT gave -0.0 (the JAX package keeps it) and
    0 under the port's rule.  Those frames are never window-clear, so
    ``extrapolate_phase`` replaces them, and its result is the same, bit for
    bit, under either rule, in both packages."""
    n_fft, hop, win = SIZES[size]
    masks = _masks(hop)
    spec = _phases(n_fft, hop, win, masks)
    zero = spec == 0
    assert zero.any() and np.signbit(spec.real[zero]).any()
    sign_rule = np.where(zero, np.where(np.signbit(spec.real), np.pi, 0.0),
                         np.angle(spec)).astype(np.float32)
    zero_rule = np.where(zero, 0.0, np.angle(spec)).astype(np.float32)
    assert not np.array_equal(sign_rule, zero_rule)
    n = spec.shape[-1]
    trust = phase.window_clear_frame_mask(torch.tensor(masks), n, hop, n_fft, win_length=win)
    assert not (zero & (trust.numpy()[:, None, :] > 0.5)).any()
    a = phase.extrapolate_phase(torch.tensor(sign_rule), trust, hop, n_fft)
    b = phase.extrapolate_phase(torch.tensor(zero_rule), trust, hop, n_fft)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    ja = jax_phase.extrapolate_phase(jnp.asarray(sign_rule), jnp.asarray(trust.numpy()), hop, n_fft)
    jb = jax_phase.extrapolate_phase(jnp.asarray(zero_rule), jnp.asarray(trust.numpy()), hop, n_fft)
    np.testing.assert_array_equal(np.asarray(ja), np.asarray(jb))


def test_all_valid_and_all_invalid():
    """No gap: the phase comes back as it was.  No trustworthy frame: both
    sides weigh 0, the blend cancels, and every frame gets phase 0, as in
    JAX."""
    ph = torch.tensor(np.random.default_rng(1).uniform(-3, 3, (2, 257, 40)).astype(np.float32))
    torch.testing.assert_close(phase.extrapolate_phase(ph, torch.ones(2, 40), 128, 512), ph,
                               rtol=0, atol=0)
    out = phase.extrapolate_phase(ph, torch.zeros(2, 40), 128, 512)
    want = np.asarray(jax_phase.extrapolate_phase(jnp.asarray(ph.numpy()), jnp.zeros((2, 40)),
                                                  128, 512))
    np.testing.assert_array_equal(out.numpy(), want)
    assert (out == 0).all()

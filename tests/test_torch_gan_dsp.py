"""The GAN serving path's DSP in the port against the JAX package on the CPU:
the frame masks, the log1p pair, the composite, the gap, PCM16, the
synthetic corpus and numpy's reflection pad.

Tolerances: masks, the gap, the composite, PCM16 and the corpus exactly
(integer rules, elementwise products of {0, 1} masks, integer levels, the
same numpy draws).  ``log1p``/``expm1``: ``rtol=1e-6`` with an absolute
floor of 4 f32 ulps at 1.0 (4.8e-7), two libraries' last-bit rounding of
one transcendental.  The reflection pad against ``np.pad`` exactly (an
index map).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.data.dataset import SyntheticSpeechDataset as JaxDataset
from ml_audio_inpainting_tpu.ops import gaps as jax_gaps
from ml_audio_inpainting_tpu.ops import masking as jax_masking
from ml_audio_inpainting_tpu.ops.pcm import from_pcm16 as jax_from_pcm16
from ml_audio_inpainting_tpu.ops.pcm import to_pcm16 as jax_to_pcm16
from ml_audio_inpainting_torch.data.dataset import SyntheticSpeechDataset
from ml_audio_inpainting_torch.models.pconv_unet import reflect_pad
from ml_audio_inpainting_torch.ops import gaps, masking
from ml_audio_inpainting_torch.ops.pcm import from_pcm16, to_pcm16
from torch_threads import one_thread  # noqa: F401  (a module fixture)

HOP = 128
N_FREQ, N_TIME, N_SAMPLES = 5, 126, 16000
TRANSCENDENTAL_ATOL = 4 * float(np.finfo(np.float32).eps)

# (start, length): at 0; running to the clip's end; of length 0; an end not
# a multiple of hop; both ends on frame boundaries; one sample; past the end
INTERVALS = [(0, 1280), (N_SAMPLES - 700, 700), (4000, 0), (3000, 1001), (10 * HOP, 5 * HOP),
             (777, 1), (15900, 500)]


def _jax_interval_mask(start, end):
    return np.asarray(jax_gaps.frame_mask_from_interval(
        jnp.asarray(start), jnp.asarray(end), N_FREQ, N_TIME, HOP))


@pytest.mark.parametrize("start,length", INTERVALS)
def test_frame_mask_from_interval_matches_jax(start, length):
    want = _jax_interval_mask(start, start + length)
    got = gaps.frame_mask_from_interval(torch.tensor(start), torch.tensor(start + length),
                                        N_FREQ, N_TIME, HOP)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (N_FREQ, N_TIME)
    # the floor/ceil rule, written out
    frames = np.arange(N_TIME)
    hole = (frames >= start // HOP) & (frames < -(-(start + length) // HOP)) & (length > 0)
    np.testing.assert_array_equal(got.numpy()[0], (~hole).astype(np.float32))


def test_frame_mask_from_interval_is_batched():
    """A ``(B,)`` batch gives the rows JAX gives one interval at a time."""
    starts = torch.tensor([s for s, _ in INTERVALS])
    ends = starts + torch.tensor([n for _, n in INTERVALS])
    got = gaps.frame_mask_from_interval(starts, ends, N_FREQ, N_TIME, HOP, dtype=torch.float64)
    assert got.shape == (len(INTERVALS), N_FREQ, N_TIME) and got.dtype == torch.float64
    for b, (s, n) in enumerate(INTERVALS):
        np.testing.assert_array_equal(got[b].numpy(), _jax_interval_mask(s, s + n))


def _multi_gap_mask(n_samples, spans):
    m = np.ones(n_samples, np.float32)
    for s, n in spans:
        m[s : s + n] = 0.0
    return m


@pytest.mark.parametrize("rule", ["any", "end"])
@pytest.mark.parametrize("n_samples,n_time", [(N_SAMPLES, N_TIME), (N_SAMPLES, 120), (1000, 10)])
def test_frame_mask_from_sample_mask_matches_jax(rule, n_samples, n_time):
    """Several gaps a row, mid-frame and on frame boundaries, a gap at each
    end; a mask longer than ``n_time * hop`` (cut) and shorter (padded)."""
    rows = np.stack([
        _multi_gap_mask(n_samples, [(0, 100), (300, 256), (n_samples - 50, 50)]),
        _multi_gap_mask(n_samples, [(HOP, HOP), (5 * HOP + 1, 3), (7 * HOP - 1, 2)]),
        _multi_gap_mask(n_samples, []),
    ])
    want = np.asarray(jax_gaps.frame_mask_from_sample_mask(
        jnp.asarray(rows), N_FREQ, n_time, HOP, rule=rule))
    got = gaps.frame_mask_from_sample_mask(torch.tensor(rows), N_FREQ, n_time, HOP, rule=rule)
    assert got.shape == (3, N_FREQ, n_time)
    np.testing.assert_array_equal(got.numpy(), want)


def test_frame_mask_from_sample_mask_reduces_to_the_interval_rule():
    """For one interval inside the clip (a sample mask has no samples past
    its end, which count as present)."""
    for s, n in INTERVALS:
        if s + n > N_SAMPLES:
            continue
        m = torch.tensor(_multi_gap_mask(N_SAMPLES, [(s, n)]))
        np.testing.assert_array_equal(
            gaps.frame_mask_from_sample_mask(m, N_FREQ, N_TIME, HOP).numpy(),
            _jax_interval_mask(s, s + n))


def test_frame_mask_from_sample_mask_refuses_an_unknown_rule():
    with pytest.raises(ValueError, match="rule"):
        gaps.frame_mask_from_sample_mask(torch.ones(256), 1, 2, HOP, rule="all")


def test_log1p_pair_and_mask_flip_match_jax():
    rng = np.random.default_rng(0)
    mag = np.abs(rng.standard_normal((3, 257, 40)) * 10.0 ** rng.uniform(-6, 2, (3, 257, 40)))
    mag = mag.astype(np.float32)
    want = np.asarray(jax_masking.log1p_norm(jnp.asarray(mag)))
    got = masking.log1p_norm(torch.tensor(mag)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=TRANSCENDENTAL_ATOL)
    np.testing.assert_allclose(masking.log1p_denorm(torch.tensor(want)).numpy(),
                               np.asarray(jax_masking.log1p_denorm(jnp.asarray(want))),
                               rtol=1e-6, atol=TRANSCENDENTAL_ATOL)
    mask = (rng.uniform(size=(3, 257, 40)) > 0.3).astype(np.float32)
    np.testing.assert_array_equal(masking.invert_mask(torch.tensor(mask)).numpy(),
                                  np.asarray(jax_masking.invert_mask(jnp.asarray(mask))))


def test_composite_and_apply_gap_match_jax():
    rng = np.random.default_rng(1)
    pred, orig = (rng.standard_normal((2, 9, 30)).astype(np.float32) for _ in range(2))
    mask = np.asarray(jax_gaps.frame_mask_from_interval(
        jnp.asarray(5 * HOP), jnp.asarray(9 * HOP + 3), 9, 30, HOP))[None].repeat(2, 0)
    got = masking.composite(torch.tensor(pred), torch.tensor(orig), torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_masking.composite(jnp.asarray(pred), jnp.asarray(orig), jnp.asarray(mask))))
    np.testing.assert_array_equal(got[mask == 1], orig[mask == 1])
    np.testing.assert_array_equal(got[mask == 0], pred[mask == 0])

    audio = rng.standard_normal((2, 4000)).astype(np.float32)
    tmask = gaps.gap_mask(4000, torch.tensor([100, 3500]), torch.tensor([640, 500]))
    got = gaps.apply_gap(torch.tensor(audio), tmask).numpy()
    want = np.asarray(jax_gaps.apply_gap(jnp.asarray(audio), jnp.asarray(tmask.numpy())))
    np.testing.assert_array_equal(got, want)
    assert not got[0, 100:740].any() and not got[1, 3500:].any()


def _exact_ties(ks):
    """f32 values x with ``f32(x * 32767)`` exactly ``k + 0.5``, for each k
    that has one among the f32 neighbours of ``(k + 0.5) / 32767``."""
    out = []
    for k in ks:
        x = np.float32((k + 0.5) / 32767.0)
        for cand in (x, np.nextafter(x, np.float32(-2)), np.nextafter(x, np.float32(2))):
            if np.float32(cand) * np.float32(32767.0) == np.float32(k + 0.5):
                out.append(cand)
                break
    return np.array(out, np.float32)


def test_pcm16_ties_and_saturation_match_jax():
    """Exact ties at half an LSB round half to even in both packages; values
    past +-1 saturate at 32767 and -32768; every int16 level makes the round
    trip exactly."""
    ties = _exact_ties([0, 1, 2, 3, 10, 11, 1000, 1001, -1, -2, -3, -4, 32765, -32766])
    products = (ties * np.float32(32767.0)).astype(np.float64)  # the f32 product, as both round it
    assert len(ties) >= 8 and np.all(products % 1 == 0.5)
    assert {int(np.floor(p)) % 2 for p in products} == {0, 1}  # even and odd below
    got = to_pcm16(torch.tensor(ties))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_to_pcm16(jnp.asarray(ties))))
    np.testing.assert_array_equal(got.numpy(), np.round(np.float32(32767.0) * ties))  # half to even
    lsb = np.float32(1.0 / 32767.0)
    edges = np.array([0.0, -0.0, 1.0, -1.0, 1.0 + lsb, -1.0 - lsb, 1.5, -1.5, 1e9, -1e9, lsb,
                      -lsb, 0.49 * lsb, 0.51 * lsb], np.float32)
    got = to_pcm16(torch.tensor(edges)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_to_pcm16(jnp.asarray(edges))))
    assert got.tolist() == [0, 0, 32767, -32767, 32767, -32768, 32767, -32768, 32767, -32768,
                            1, -1, 0, 1]

    every = np.arange(-32768, 32768, dtype=np.int16)
    back = from_pcm16(torch.tensor(every))
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_from_pcm16(jnp.asarray(every))))
    np.testing.assert_array_equal(to_pcm16(back).numpy(), every)


@pytest.mark.parametrize("seed,max_len_s", [(0, 5.0), (3, 0.25)])
def test_synthetic_dataset_matches_jax_bit_for_bit(seed, max_len_s):
    port, ref = (cls(n_items=4, max_len_s=max_len_s, seed=seed)
                 for cls in (SyntheticSpeechDataset, JaxDataset))
    assert len(port) == len(ref) == 4 and port.max_samples == ref.max_samples
    for i in (0, 1, 3):
        a, b = port[i], ref[i]
        assert a.dtype == np.float32 and a.shape == (int(16000 * max_len_s),)
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(port[0], port[1])


@pytest.mark.parametrize("n,pad", [(5, 3), (5, 4), (5, 9), (5, 21), (3, 2), (2, 7), (1, 4),
                                   (257, 127), (63, 65), (7, 0)])
def test_reflect_pad_matches_numpy(n, pad):
    """numpy's reflection, including pads as long as the axis and longer
    (``F.pad(mode="reflect")`` raises there), on each axis and on both."""
    rng = np.random.default_rng(n * 100 + pad)
    x = rng.standard_normal((2, 3, n, n + 1)).astype(np.float32)
    for pad_h, pad_w in ((pad, 0), (0, pad), (pad, pad + 1)):
        want = np.pad(x, ((0, 0), (0, 0), (0, pad_h), (0, pad_w)), mode="reflect")
        got = reflect_pad(torch.tensor(x), pad_h, pad_w)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            np.asarray(jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, pad_h), (0, pad_w)),
                               mode="reflect")), want)

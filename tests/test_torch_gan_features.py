"""GAN training features of the port (``train/features.py::gan_features``,
``train/recipe.py::gan_gap_layouts``) against the JAX package's
(``train/features.py:34-100``) on the CPU.

The JAX function draws its gaps from a ``jax.random`` key; these tests
derive the same positions from the key's splits (``random_gap_mask`` for
one gap a clip, ``multi_gap_mask`` for several) and hand them to the port.

Tolerances: masks bit for bit; ``original_magnitude`` and
``impaired_magnitude`` (log1p of STFT magnitudes, FFTs summed in another
order) within 1e-5 of their peak; ``original_phase`` weighted by its bin's
magnitude (``|S| |dphi|``, the error of the complex bin it stands for,
wrapped) within 1e-5 of the peak magnitude: an FFT rounding of ~1e-7 of
the peak turns the angle of a bin of magnitude m by ~1e-7 peak / m, so
the angle alone is ill-conditioned on quiet bins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.data.multigap import multi_gap_mask as jax_multi_gap_mask
from ml_audio_inpainting_tpu.ops import gaps as jax_gaps
from ml_audio_inpainting_tpu.train import features as jax_features
from ml_audio_inpainting_tpu.utils.config import SpectrogramConfig as JaxSpec
from ml_audio_inpainting_torch.train.features import gan_features
from ml_audio_inpainting_torch.train.recipe import gan_gap_layouts, gan_recipe_config
from ml_audio_inpainting_torch.utils.config import SpectrogramConfig
from torch_threads import one_thread  # noqa: F401  (a module fixture)

SR, N, B = 16000, 16000, 3
GAP_S = 0.1
SPEC = dict(n_fft=512, hop_length=128, win_length=512)


def gaps_of_key(key, n_gaps, clips=B, n=N, gap_s=GAP_S):
    """The gap tensors JAX's ``gan_features`` draws from ``key``."""
    keys = jax.random.split(key, clips)
    if n_gaps == 1:
        starts = jax.vmap(lambda k: jax_gaps.random_gap_mask(k, n, gap_s, SR)[1][0])(keys)
        return (torch.tensor(np.asarray(starts), dtype=torch.int64),)
    _, starts, lens = jax.vmap(lambda k: jax_multi_gap_mask(
        k, n, n_gaps, max_gap_ms=gap_s * 1000.0, sample_rate=SR))(keys)
    return (torch.tensor(np.asarray(starts), dtype=torch.int64),
            torch.tensor(np.asarray(lens), dtype=torch.int64))


def _audio(seed=0, clips=B, n=N):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    return np.stack([np.sin(2 * np.pi * rng.uniform(100, 400) * t) * (0.6 + 0.4 * np.sin(3 * t))
                     + 0.05 * rng.standard_normal(n) for _ in range(clips)]).astype(np.float32)


@pytest.mark.parametrize("n_gaps", [1, 4])
def test_gan_features_match_jax(n_gaps):
    audio = _audio()
    key = jax.random.PRNGKey(11 + n_gaps)
    want = jax_features.gan_features(jnp.asarray(audio), key, JaxSpec(**SPEC), gap_len_s=GAP_S,
                                     sample_rate=SR, n_samples=N, n_gaps=n_gaps)
    gaps = gaps_of_key(key, n_gaps)
    got = gan_features(torch.tensor(audio), gaps[0], SpectrogramConfig(**SPEC), gap_len_s=GAP_S,
                       sample_rate=SR, n_gaps=n_gaps, gap_len=gaps[1] if n_gaps > 1 else None)
    assert set(got) == set(want)
    mask_w, mask_g = np.asarray(want["mask"]), got["mask"].numpy()
    assert mask_g.shape == mask_w.shape and np.array_equal(mask_g, mask_w)
    assert (mask_w == 0).any(axis=(1, 2)).all()  # every clip has a hole
    for key_ in ("original_magnitude", "impaired_magnitude"):
        w = np.asarray(want[key_])
        np.testing.assert_allclose(got[key_].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=key_)
    mag = np.expm1(np.asarray(want["original_magnitude"]))
    d = np.angle(np.exp(1j * (got["original_phase"].numpy() - np.asarray(want["original_phase"]))))
    assert (mag * np.abs(d)).max() <= 1e-5 * mag.max()


def test_one_gap_edge_lengths_match_random_gap_mask():
    """A gap of length 0 is none, and one as long as the clip is the whole
    clip, whatever the start (``random_gap_mask``'s rule)."""
    audio = torch.tensor(_audio(clips=1, n=2048))
    spec = SpectrogramConfig(**SPEC)
    none = gan_features(audio, torch.tensor([500]), spec, gap_len_s=0.0, sample_rate=SR)
    assert torch.equal(none["impaired_magnitude"], none["original_magnitude"])
    assert bool((none["mask"] == 1).all())
    whole = gan_features(audio, torch.tensor([500]), spec, gap_len_s=1.0, sample_rate=SR)
    assert bool((whole["impaired_magnitude"] == 0).all())
    # [0, 2048) covers frames [0, 16) of 17; the centred last frame stays valid
    assert bool((whole["mask"][..., :16] == 0).all()) and bool((whole["mask"][..., 16] == 1).all())


def test_gan_gap_layouts_draw_valid_gaps():
    """The recipe's helper: one start a clip for one gap, or K ordered,
    non-overlapping gaps of up to ``gap_len_s`` inside the clip."""
    cfg = gan_recipe_config()
    gen = torch.Generator().manual_seed(0)
    starts, lengths = gan_gap_layouts(gen, cfg, 32)
    assert starts.shape == lengths.shape == (32, 4) and starts.dtype == torch.int64
    assert bool((lengths <= 0.2 * SR).all()) and bool((lengths > 0).all())
    ends = starts + lengths
    assert bool((starts[:, 1:] >= ends[:, :-1]).all()) and bool((ends <= 80000).all())
    cfg.data.train_n_gaps = 1
    (one,) = gan_gap_layouts(gen, cfg, 32)
    assert one.shape == (32,) and bool((one >= 0).all()) and bool((one <= 80000 - 3200).all())

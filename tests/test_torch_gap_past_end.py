"""Gaps that run past the clip's end, through the port's interval functions
(``runtime/inference.py::make_gan_inpaint_fn``, ``make_cnn_inpaint_fn``)
against the JAX package's, on the CPU, in the ``oracle`` and
``extrapolate`` regimes.

The JAX functions take the frame mask from the interval itself: the GAN's
frames ``[start // hop, ceil(end / hop))`` and the CNN+BiLSTM's ``[start //
hop, end // hop)``, ``end = start + len`` even where it lies past the clip.
A mask built from the clip's sample mask drops the part past the end, and
leaves the last frame valid; the port's generator and CNN then see another
input and the results move by up to ~0.85 (tiny GAN and narrow CNN, 1 s
clips).  The gaps: (15500, 1000), (15900, 300), (15000, 1200) and
(15990, 500) end past the 16 000-sample clip; (15000, 1000) ends exactly at
it.

Tolerances as in ``tests/test_torch_gan_inference.py`` and
``tests/test_torch_deployable_inference.py``: the generator's output within
``1e-5``, the CNN's composited log10 magnitude within ``1e-3`` (``5e-5`` on
the gap frames); the waveform under ``oracle`` within ``2e-5``; under
``extrapolate`` the input outside the gap bit for bit in both packages, and
inside it each clip within ``2e-3`` of the largest |sample| of JAX's
restored gap.
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.models.cnn_blstm import StackedBLSTMCNN as JaxCNN
from ml_audio_inpainting_tpu.runtime import inference as jax_inference
from ml_audio_inpainting_tpu.train.gan_trainer import build_generator as jax_build_generator
from ml_audio_inpainting_tpu.utils.config import Config as JaxConfig
from ml_audio_inpainting_tpu.utils.config import SpectrogramConfig as JaxSpectrogramConfig
from ml_audio_inpainting_torch.models.build import build_generator
from ml_audio_inpainting_torch.runtime import inference
from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from ml_audio_inpainting_torch.utils.config import Config, SpectrogramConfig
from ml_audio_inpainting_torch.weights import cnn_blstm_from_numpy, pconv_unet_state_dict
from torch_threads import one_thread  # noqa: F401  (a module fixture)

SR = 16000
PAST_END = (np.array([15500, 15900, 15000, 15990]), np.array([1000, 300, 1200, 500]))
AT_END = (np.array([15000, 14000]), np.array([1000, 2000]))
GEN_ATOL, WAVE_ATOL, EXTRAPOLATE_RTOL = 1e-5, 2e-5, 2e-3


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, Mapping) else {key: np.asarray(v)})
    return out


def _redrawn(variables, rng, scale):
    return jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.asarray(
            rng.uniform(0.5, 2.0, p.shape) if str(path[-1].key) == "var"
            else rng.standard_normal(p.shape) * scale, jnp.float32),
        variables,
    )


@pytest.fixture(scope="module")
def tiny_gan():
    jcfg, cfg = JaxConfig(), Config()
    jcfg.data.spectrogram = JaxSpectrogramConfig(n_fft=512, hop_length=128, win_length=512)
    cfg.data.spectrogram = SpectrogramConfig(n_fft=512, hop_length=128, win_length=512)
    for c in (jcfg, cfg):
        c.data.max_len_s = 1.0
        c.model.generator.enc_layer_cfg = [(8, 7, 2), (16, 5, 2), (16, 3, 2)]
        c.model.generator.dec_layer_cfg = [(16, 3, 1), (8, 3, 1)]
        c.model.generator.final_interim_ch = 8
    jgen = jax_build_generator(jcfg)
    variables = jax.jit(lambda k, a, m: jgen.init(k, a, m, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 257, 126)), jnp.ones((1, 257, 126)))
    variables = _redrawn(variables, np.random.default_rng(0), 0.15)
    gen = build_generator(cfg, device="cpu")
    gen.load_state_dict(pconv_unet_state_dict(_flatten(variables)))
    return jcfg, cfg, jgen, variables, gen


@pytest.fixture(scope="module")
def narrow_cnn():
    jmodel = JaxCNN(num_lstm_layers=2, lstm_hidden_dim=16, freq_bins=257,
                    enc_filters=(4, 8), dec_filters=(4, 8))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 257, 84)), train=False)
    variables = _redrawn(variables, np.random.default_rng(21), 0.2)
    return jmodel, variables, cnn_blstm_from_numpy(_flatten(variables), device="cpu")


def _check_wave(got, want, audio, gaps, phase):
    if phase == "oracle":
        np.testing.assert_allclose(got, want, rtol=0, atol=WAVE_ATOL)
        return
    idx = np.arange(audio.shape[-1])
    inside = (idx >= gaps[0][:, None]) & (idx < (gaps[0] + gaps[1])[:, None])
    np.testing.assert_array_equal(got[~inside], audio[~inside])
    np.testing.assert_array_equal(want[~inside], audio[~inside])
    for g, w, i in zip(got, want, inside):
        np.testing.assert_allclose(g[i], w[i], rtol=0, atol=EXTRAPOLATE_RTOL * np.abs(w[i]).max())


@pytest.mark.parametrize("gaps", [PAST_END, AT_END], ids=["past_end", "at_end"])
@pytest.mark.parametrize("phase", ["oracle", "extrapolate"])
def test_gan_gap_past_the_end_matches_jax(tiny_gan, phase, gaps):
    jcfg, cfg, jgen, variables, gen = tiny_gan
    audio = speech_like_batch(np.random.default_rng(11), len(gaps[0]), 1.0)
    want = jax_inference.make_gan_inpaint_fn(jcfg, jgen, mode="enhanced", phase=phase)(
        variables, jnp.asarray(audio), jnp.asarray(gaps[0]), jnp.asarray(gaps[1]))
    got = inference.make_gan_inpaint_fn(cfg, gen, mode="enhanced", phase=phase)(
        torch.tensor(audio), torch.tensor(gaps[0]), torch.tensor(gaps[1]))
    want, got = [np.asarray(w) for w in want], [g.numpy() for g in got]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=GEN_ATOL)
    _check_wave(got[0], want[0], audio, gaps, phase)


@pytest.mark.parametrize("gaps", [PAST_END, AT_END], ids=["past_end", "at_end"])
@pytest.mark.parametrize("phase", ["oracle", "extrapolate"])
def test_cnn_gap_past_the_end_matches_jax(narrow_cnn, phase, gaps):
    jmodel, variables, model = narrow_cnn
    audio = speech_like_batch(np.random.default_rng(12), len(gaps[0]), 1.0)
    want = jax_inference.make_cnn_inpaint_fn(JaxConfig(), jmodel, phase=phase)(
        variables, jnp.asarray(audio), jnp.asarray(gaps[0]), jnp.asarray(gaps[1]))
    got = inference.make_cnn_inpaint_fn(Config(), model, phase=phase)(
        torch.tensor(audio), torch.tensor(gaps[0]), torch.tensor(gaps[1]))
    want, got = [np.asarray(w) for w in want], [g.numpy() for g in got]
    t = np.arange(got[1].shape[-1])
    hole = (t >= gaps[0][:, None] // 192) & (t < (gaps[0] + gaps[1])[:, None] // 192)
    assert hole[:, -1].any() == (gaps is PAST_END)  # the last frame is a gap frame
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1].transpose(0, 2, 1)[hole],
                               want[1].transpose(0, 2, 1)[hole], rtol=0, atol=5e-5)
    _check_wave(got[0], want[0], audio, gaps, phase)

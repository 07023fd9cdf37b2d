"""The port's long-form serving (``runtime/longform.py``: ``chunk_signal``,
``overlap_add``, ``longform_inpaint`` with its rounds, ``pad_batches`` and
``gap_fetch``, ``make_centered_gap_fn`` and ``longform_inpaint_centered``)
against the JAX package's ``runtime/longform.py`` on the CPU, around the
tiny generator and a narrow CNN+BiLSTM with the same redrawn weights, under
``extrapolate``, on a seeded speech-like 4 s signal.

The gaps: two in the first window (restored in two rounds), one of 0.5 s,
one running into the signal's end; the centered path takes three gaps a
window or more apart, in two calls of two (one padded).

What differs, and the tolerances:

* ``chunk_signal``: exactly.  ``overlap_add``: ``atol=1e-6`` (sums of two
  Hann-weighted windows in another order).
* The restored signal outside the gaps: the port's is the input bit for bit
  (it composites at the end); JAX's is the overlap-add of windows that each
  keep the input there, within ``1e-6`` of it.
* Inside the gaps: the ``extrapolate`` rounding of
  ``tests/test_torch_deployable_inference.py`` through the overlap-add of up
  to three windows: ``3e-3`` of each gap's peak (1.4e-3 seen, the narrow
  CNN's 0.5 s gap; at most 5.4e-5 on the others).
* PCM16 patches: the same starts; samples within ``1 + 3e-3 * peak``
  LSB (the waveform bound, plus one for rounding; up to 4 seen), and the
  host composite of the patches equal to the PCM16 of the full restored
  signal.
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.models.cnn_blstm import StackedBLSTMCNN as JaxCNN
from ml_audio_inpainting_tpu.runtime import inference as jax_inference
from ml_audio_inpainting_tpu.runtime import longform as jax_longform
from ml_audio_inpainting_tpu.train.gan_trainer import build_generator as jax_build_generator
from ml_audio_inpainting_tpu.utils.config import Config as JaxConfig
from ml_audio_inpainting_tpu.utils.config import SpectrogramConfig as JaxSpectrogramConfig
from ml_audio_inpainting_torch.models.build import build_generator
from ml_audio_inpainting_torch.ops.pcm import to_pcm16
from ml_audio_inpainting_torch.runtime import inference, longform
from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from ml_audio_inpainting_torch.runtime.transport import composite_gap_patches_1d
from ml_audio_inpainting_torch.utils.config import Config, SpectrogramConfig
from ml_audio_inpainting_torch.weights import cnn_blstm_from_numpy, pconv_unet_state_dict
from torch_threads import one_thread  # noqa: F401  (a module fixture)

SR = 16000
WINDOW, HOP = SR, SR // 2
GAP_START = np.array([3000, 7000, 20000, 63100])
GAP_LEN = np.array([1280, 1000, SR // 2, 900])
RTOL_OF_PEAK = 3e-3


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, Mapping) else {key: np.asarray(v)})
    return out


def _redrawn(variables, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.asarray(
            rng.uniform(0.5, 2.0, p.shape) if str(path[-1].key) == "var"
            else rng.standard_normal(p.shape) * scale, jnp.float32),
        variables,
    )


def _gan_fns():
    """(JAX fn, its variables, the port's fn): the tiny generator under
    ``enhanced``/``extrapolate``."""
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
    variables = _redrawn(variables, 0, 0.15)
    gen = build_generator(cfg, device="cpu")
    gen.load_state_dict(pconv_unet_state_dict(_flatten(variables)))
    return (jax_inference.make_gan_inpaint_fn(jcfg, jgen, mode="enhanced", phase="extrapolate"),
            variables,
            inference.make_gan_inpaint_fn(cfg, gen, mode="enhanced", phase="extrapolate"))


def _cnn_fns():
    jmodel = JaxCNN(num_lstm_layers=2, lstm_hidden_dim=16, freq_bins=257,
                    enc_filters=(4, 8), dec_filters=(4, 8))
    variables = _redrawn(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 257, 84)),
                                     train=False), 21, 0.2)
    model = cnn_blstm_from_numpy(_flatten(variables), device="cpu")
    return (jax_inference.make_cnn_inpaint_fn(JaxConfig(), jmodel, phase="extrapolate"),
            variables, inference.make_cnn_inpaint_fn(Config(), model, phase="extrapolate"))


def _signal(seconds=4.0):
    return speech_like_batch(np.random.default_rng(13), 1, seconds)[0]


def _inside(n, starts, lens):
    idx = np.arange(n)
    return (idx >= starts[:, None]) & (idx < (starts + lens)[:, None])


def _check_gaps(got, want, audio, starts, lens):
    """The port exact outside the gaps, JAX's overlap-add within 1e-6 of
    the input there; each gap within RTOL_OF_PEAK of its peak."""
    inside = _inside(len(audio), starts, lens)
    outside = ~inside.any(axis=0)
    np.testing.assert_array_equal(got[outside], audio[outside])
    np.testing.assert_allclose(want[outside], audio[outside], rtol=0, atol=1e-6)
    for i in inside:
        np.testing.assert_allclose(got[i], want[i], rtol=0,
                                   atol=RTOL_OF_PEAK * np.abs(want[i]).max())


@pytest.mark.parametrize("t", [SR, 3 * SR + 5, 10, 64000])
def test_chunk_signal_matches_jax(t):
    audio = np.arange(t, dtype=np.float32)
    got, padded = longform.chunk_signal(torch.tensor(audio), WINDOW, HOP)
    want, want_padded = jax_longform.chunk_signal(jnp.asarray(audio), WINDOW, HOP)
    assert padded == want_padded
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_overlap_add_matches_jax():
    windows = np.random.default_rng(0).standard_normal((7, WINDOW)).astype(np.float32)
    got = longform.overlap_add(torch.tensor(windows), HOP, 6 * HOP + 100)
    want = jax_longform.overlap_add(jnp.asarray(windows), HOP, 6 * HOP + 100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # a signal cut into windows comes back (each sample a weighted mean of itself)
    audio = torch.tensor(_signal(2.0))
    back = longform.overlap_add(longform.chunk_signal(audio, WINDOW, HOP)[0], HOP, len(audio))
    torch.testing.assert_close(back, audio, rtol=0, atol=1e-6)


@pytest.mark.parametrize("family", ["gan", "cnn"])
@pytest.mark.parametrize("pad_batches", [False, True])
def test_longform_inpaint_matches_jax(family, pad_batches):
    jfn, variables, fn = _gan_fns() if family == "gan" else _cnn_fns()
    audio = _signal()
    want = np.asarray(jax_longform.longform_inpaint(
        jfn, variables, jnp.asarray(audio), GAP_START, GAP_LEN, window=WINDOW, hop=HOP,
        batch_size=2, pad_batches=pad_batches))
    got = longform.longform_inpaint(fn, torch.tensor(audio), GAP_START, GAP_LEN, window=WINDOW,
                                    hop=HOP, batch_size=2, pad_batches=pad_batches).numpy()
    assert got.shape == audio.shape and got.dtype == np.float32 and np.isfinite(got).all()
    _check_gaps(got, want, audio, GAP_START, GAP_LEN)


def test_longform_rounds_restore_every_gap_of_a_window():
    """The first window holds two gaps: two rounds, the second reading the
    first's result.  Calls: windows meeting a gap, at most ``batch_size``
    a call, each window at most once a round."""
    calls = []
    _, _, fn = _gan_fns()

    def spy(audio, gs, gl):
        calls.append((audio.shape[0], gs.tolist(), gl.tolist()))
        return fn(audio, gs, gl)

    audio = _signal()
    got = longform.longform_inpaint(spy, torch.tensor(audio), GAP_START, GAP_LEN, window=WINDOW,
                                    hop=HOP, batch_size=2)
    # 7 windows at 0, 8000, ..., 48000: window 0 meets gaps 0 and 1, windows
    # 1-3 the 0.5 s gap, window 6 the last: round 1 has 5 items, round 2 one
    assert [c[0] for c in calls] == [2, 2, 1, 1]
    assert calls[-1][1:] == ([7000], [1000])  # round 2: window 0's second gap
    inside = _inside(len(audio), GAP_START, GAP_LEN)
    assert all(not np.allclose(got.numpy()[i], 0.0) for i in inside)


@pytest.mark.parametrize("family", ["gan", "cnn"])
def test_gap_fetch_patches_match_jax(family):
    jfn, variables, fn = _gan_fns() if family == "gan" else _cnn_fns()
    audio = _signal()
    starts, lens = GAP_START[[0, 1, 3]], GAP_LEN[[0, 1, 3]]
    wp, ws = jax_longform.longform_inpaint(jfn, variables, jnp.asarray(audio), starts, lens,
                                           window=WINDOW, hop=HOP, batch_size=2, gap_fetch=2048)
    patches, pstarts = longform.longform_inpaint(fn, torch.tensor(audio), starts, lens,
                                                 window=WINDOW, hop=HOP, batch_size=2,
                                                 gap_fetch=2048)
    assert patches.dtype == torch.int16 and pstarts.dtype == torch.int32
    np.testing.assert_array_equal(pstarts.numpy(), np.asarray(ws))
    full = longform.longform_inpaint(fn, torch.tensor(audio), starts, lens, window=WINDOW,
                                     hop=HOP, batch_size=2)
    lsb = 1 + RTOL_OF_PEAK * np.abs(full.numpy()[_inside(len(audio), starts, lens).any(0)]).max() \
        * 32767
    diff = np.abs(patches.numpy().astype(np.int32) - np.asarray(wp).astype(np.int32))
    assert diff.max() <= lsb, (diff.max(), lsb)
    client = to_pcm16(torch.tensor(audio)).numpy()
    host = composite_gap_patches_1d(client, patches.numpy(), pstarts.numpy())
    np.testing.assert_array_equal(host, to_pcm16(full).numpy())


@pytest.mark.parametrize("family", ["gan", "cnn"])
def test_centered_matches_jax(family):
    jfn, variables, fn = _gan_fns() if family == "gan" else _cnn_fns()
    audio = _signal()
    starts, lens = np.array([50000, 2000, 25000]), np.array([1280, 700, 2000])
    wp, ws = jax_longform.longform_inpaint_centered(jfn, variables, jnp.asarray(audio), starts,
                                                    lens, window=WINDOW, batch_size=2,
                                                    patch_window=2048)
    patches, pstarts = longform.longform_inpaint_centered(fn, torch.tensor(audio), starts, lens,
                                                          window=WINDOW, batch_size=2,
                                                          patch_window=2048)
    assert patches.shape == (3, 2048) and patches.dtype == torch.int16
    np.testing.assert_array_equal(pstarts.numpy(), ws)
    client = to_pcm16(torch.tensor(audio)).numpy()
    host = composite_gap_patches_1d(client, patches.numpy(), pstarts.numpy())
    want = composite_gap_patches_1d(client, wp, ws)
    inside = _inside(len(audio), starts, lens).any(0)
    np.testing.assert_array_equal(host[~inside], client[~inside])
    peak = np.abs(want[inside]).max()
    assert np.abs(host.astype(np.int32) - want).max() <= 1 + RTOL_OF_PEAK * peak


def test_centered_rejects_clustered_gaps_and_short_signals():
    _, _, fn = _gan_fns()
    audio = torch.tensor(_signal(2.0))
    with pytest.raises(ValueError, match="spacing"):
        longform.longform_inpaint_centered(fn, audio, [1000, 9000], [500, 500], window=WINDOW)
    with pytest.raises(ValueError, match="exceeds"):
        longform.make_centered_gap_fn(fn, 3 * SR)(audio, torch.tensor([100]), torch.tensor([10]))


def test_no_gap_returns_the_input():
    calls = []
    audio = torch.tensor(_signal(2.0))
    out = longform.longform_inpaint(lambda *a: calls.append(a), audio, [], [], window=WINDOW,
                                    hop=HOP)
    assert not calls
    torch.testing.assert_close(out, audio, rtol=0, atol=0)

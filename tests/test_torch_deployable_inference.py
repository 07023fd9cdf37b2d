"""Deployable serving in the port (``runtime/inference.py``: the
``extrapolate`` and ``griffinlim`` regimes of ``make_gan_inpaint_fn`` and
``make_cnn_inpaint_fn``, the mask-driven ``make_gan_inpaint_mask_fn`` and
``make_cnn_inpaint_mask_fn``, the shift ensemble ``make_tta_shift_fn``; the
runners' ``gl_iters``; ``data/multigap.py``'s ``cos2_fade``,
``apply_gaps_with_fades`` and ``eval_gap_table``) against the JAX package's
functions on the CPU, from the same variables and numpy clips.

Models: the tiny generator of ``tests/test_inference.py`` and a narrow
CNN+BiLSTM (2 layers of 16), each with redrawn weights and BatchNorm
statistics, and the committed ``gan_formant_v2_r2.npz`` and
``cnn_blstm_formant_v2_r2.npz`` on 1 s clips.  The gaps of a batch: at the
clip's start, running into its end, one frame long, and 0.5 s long; the
mask-driven functions take three seeded gaps a clip (the port's
``multi_gap_mask``), and two gaps with a one-frame valid run between them.

What differs between the packages, and the tolerances:

* Outside the gaps every deployable regime returns the input's own samples,
  exactly, in both packages.
* The model's output as in ``tests/test_torch_gan_inference.py`` and
  ``tests/test_torch_inference.py`` (f32 ``generated`` 1e-5 tiny, 5e-5 at
  the default widths; CNN ``composited`` 1e-3, on the gap frames 5e-5).
* Inside the gaps each clip is held within a share of the largest |sample|
  of its restored gaps (peaks ~0.02-1).  ``extrapolate``: the magnitudes'
  rounding and the extrapolated phase's through one iSTFT, ``2e-3`` of the
  peak (8.0e-4 seen on the narrow CNN's 0.5 s gap: its random prediction
  puts large magnitudes on bins that are quiet at the gap's edges, whose
  phase the two FFTs round differently, and the extrapolation carries that
  over 41 frames; at most 8.7e-5 on gaps up to 80 ms and 2.4e-5 with the
  committed checkpoints).  The zero-bin phase rule (Queue C item 4) does
  not reach it: those frames are never window-clear
  (``tests/test_torch_phase.py``).
* ``griffinlim`` at ``gl_iters=4``: ``1e-2`` of the peak (5.1e-3 seen, the
  same 0.5 s gap; at most 2.8e-4 elsewhere).  At the default 64 iterations
  the waveform inside a gap is not a stable function of the inputs: the
  generator's magnitudes there are not the spectrum of any signal, and
  momentum Griffin-Lim wanders among near-equivalent phases, so a 1e-7
  relative change of the input clip moves the restored 80 ms gap of the
  committed GAN by 7e-2 of its peak (its STFT magnitude over the gap by
  4.7e-3).  At 64 iterations the tests hold every gap's STFT magnitude over
  its frames within ``0.1`` of JAX's in relative L2 norm (3.7e-2 seen, on
  the committed GAN's 0.5 s gap); ``tests/test_torch_griffinlim.py`` holds
  the algorithm itself at 64 iterations on a consistent spectrogram.
* bf16 generator (``compute_dtype``) against JAX's bf16: ``generated``
  within ``3e-2``, the waveform inside the gaps within ``1e-2`` of the peak
  (2.8e-3 seen).
* The shift ensemble (1 and 4 shifts): the ``extrapolate`` bound.
"""

import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.data import multigap as jax_multigap
from ml_audio_inpainting_tpu.models.cnn_blstm import StackedBLSTMCNN as JaxCNN
from ml_audio_inpainting_tpu.runtime import inference as jax_inference
from ml_audio_inpainting_tpu.train.checkpoints import load_params_npz as jax_load_npz
from ml_audio_inpainting_tpu.train.gan_trainer import build_generator as jax_build_generator
from ml_audio_inpainting_tpu.utils.config import Config as JaxConfig
from ml_audio_inpainting_tpu.utils.config import SpectrogramConfig as JaxSpectrogramConfig
from ml_audio_inpainting_torch.data import multigap
from ml_audio_inpainting_torch.models.build import build_generator
from ml_audio_inpainting_torch.ops.stft import stft
from ml_audio_inpainting_torch.runtime import inference
from ml_audio_inpainting_torch.runtime.serve import make_cnn_runner, make_gan_runner
from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from ml_audio_inpainting_torch.utils.config import Config, SpectrogramConfig
from ml_audio_inpainting_torch.weights import (
    cnn_blstm_from_numpy,
    load_params_npz,
    pconv_unet_state_dict,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAN_CKPT = os.path.join(REPO, "results", "checkpoints", "gan_formant_v2_r2.npz")
CNN_CKPT = os.path.join(REPO, "results", "checkpoints", "cnn_blstm_formant_v2_r2.npz")
SR = 16000
GAN_HOP, CNN_HOP = 128, 192
GAN_KW = dict(n_fft=512, hop_length=GAN_HOP, win_length=512)
CNN_KW = dict(n_fft=512, hop_length=CNN_HOP, win_length=384)
# at the clip's start; into its end; one frame; 0.5 s
GAN_GAPS = (np.array([0, 15000, 40 * GAN_HOP, 4000]), np.array([700, 1000, GAN_HOP, SR // 2]))
CNN_GAPS = (np.array([0, 15000, 20 * CNN_HOP, 4000]), np.array([700, 1000, CNN_HOP, SR // 2]))
DEPLOYABLE = ("extrapolate", "griffinlim")
GEN_ATOL, GEN_ATOL_DEFAULT_WIDTH = 1e-5, 5e-5
WAVE_RTOL = {"extrapolate": 2e-3, "griffinlim": 1e-2}  # of each clip's gap peak
GL_FEW = 4  # griffinlim iterations of the tight comparisons
GL_64_SPEC_RTOL = 0.1
BF16_GEN_ATOL, BF16_WAVE_RTOL = 3e-2, 1e-2


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


def _gan_configs(tiny: bool):
    jcfg, cfg = JaxConfig(), Config()
    jcfg.data.spectrogram = JaxSpectrogramConfig(n_fft=512, hop_length=128, win_length=512)
    cfg.data.spectrogram = SpectrogramConfig(n_fft=512, hop_length=128, win_length=512)
    for c in (jcfg, cfg):
        c.data.max_len_s = 1.0
        if tiny:
            c.model.generator.enc_layer_cfg = [(8, 7, 2), (16, 5, 2), (16, 3, 2)]
            c.model.generator.dec_layer_cfg = [(16, 3, 1), (8, 3, 1)]
            c.model.generator.final_interim_ch = 8
    return jcfg, cfg


def _tiny_gan(seed=0):
    """(jcfg, cfg, JAX generator, variables, port generator) with the same
    redrawn weights."""
    jcfg, cfg = _gan_configs(tiny=True)
    jgen = jax_build_generator(jcfg)
    variables = jax.jit(lambda k, a, m: jgen.init(k, a, m, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, 257, 126)), jnp.ones((1, 257, 126)))
    variables = _redrawn(variables, np.random.default_rng(seed), 0.15)
    gen = build_generator(cfg, device="cpu")
    gen.load_state_dict(pconv_unet_state_dict(_flatten(variables)))
    return jcfg, cfg, jgen, variables, gen


def _narrow_cnn(seed=21):
    jmodel = JaxCNN(num_lstm_layers=2, lstm_hidden_dim=16, freq_bins=257,
                    enc_filters=(4, 8), dec_filters=(4, 8))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 257, 84)), train=False)
    variables = _redrawn(variables, np.random.default_rng(seed), 0.2)
    return jmodel, variables, cnn_blstm_from_numpy(_flatten(variables), device="cpu")


def _clips(n=4, seed=11):
    return speech_like_batch(np.random.default_rng(seed), n, 1.0)


def _inside(starts, lens, n=SR):
    idx = np.arange(n)
    return (idx >= np.asarray(starts)[:, None]) & (idx < (np.asarray(starts) + lens)[:, None])


def _check_wave(got, want, audio, inside, rtol_of_peak, rows=None):
    """Both packages keep the input outside the gaps bit for bit; inside,
    each clip of ``rows`` (all by default) of the port within
    ``rtol_of_peak`` of the largest |sample| of JAX's restored gaps in that
    clip."""
    assert got.shape == want.shape == audio.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[~inside], audio[~inside])
    np.testing.assert_array_equal(want[~inside], audio[~inside])
    for b in range(len(got)) if rows is None else rows:
        g, w, i = got[b], want[b], inside[b]
        np.testing.assert_allclose(g[i], w[i], rtol=0, atol=rtol_of_peak * np.abs(w[i]).max())


def _check_gl64(got, want, audio, gaps, kw):
    """Griffin-Lim at 64 iterations: the input outside the gaps, and the
    STFT magnitude over every gap's frames."""
    _check_wave(got, want, audio, _inside(*gaps), 0.0, rows=[])
    spec_g, spec_w = (stft(torch.tensor(x), **kw).abs() for x in (got, want))
    hop = kw["hop_length"]
    for b, (s, l) in enumerate(zip(*gaps)):
        f0, f1 = s // hop, -(-(s + l) // hop)
        g, w = spec_g[b, :, f0:f1], spec_w[b, :, f0:f1]
        assert (g - w).norm() <= GL_64_SPEC_RTOL * w.norm()


def _run_gan(jgen, variables, gen, jcfg, cfg, audio, gaps, phase, gl_iters, jdtype=None,
             dtype=None):
    jfn = jax_inference.make_gan_inpaint_fn(jcfg, jgen, mode="enhanced", phase=phase,
                                            gl_iters=gl_iters, compute_dtype=jdtype)
    want = jfn(variables, jnp.asarray(audio), jnp.asarray(gaps[0]), jnp.asarray(gaps[1]))
    fn = inference.make_gan_inpaint_fn(cfg, gen, mode="enhanced", phase=phase,
                                       gl_iters=gl_iters, compute_dtype=dtype)
    got = fn(torch.tensor(audio), torch.tensor(gaps[0]), torch.tensor(gaps[1]))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _run_cnn(jmodel, variables, model, audio, gaps, phase, gl_iters):
    jfn = jax_inference.make_cnn_inpaint_fn(JaxConfig(), jmodel, phase=phase, gl_iters=gl_iters)
    want = jfn(variables, jnp.asarray(audio), jnp.asarray(gaps[0]), jnp.asarray(gaps[1]))
    fn = inference.make_cnn_inpaint_fn(Config(), model, phase=phase, gl_iters=gl_iters)
    got = fn(torch.tensor(audio), torch.tensor(gaps[0]), torch.tensor(gaps[1]))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _check_cnn_composited(got_c, want_c, hole_frames):
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got_c.transpose(0, 2, 1)[hole_frames],
                               want_c.transpose(0, 2, 1)[hole_frames], rtol=0, atol=5e-5)


def _cnn_hole_frames(gaps, n_frames=84):
    t = np.arange(n_frames)
    return (t >= gaps[0][:, None] // CNN_HOP) & (t < (gaps[0] + gaps[1])[:, None] // CNN_HOP)


@pytest.mark.parametrize("phase", DEPLOYABLE)
def test_tiny_generator_matches_jax(phase):
    jcfg, cfg, jgen, variables, gen = _tiny_gan()
    audio = _clips()
    want, got = _run_gan(jgen, variables, gen, jcfg, cfg, audio, GAN_GAPS, phase, GL_FEW)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=GEN_ATOL)
    _check_wave(got[0], want[0], audio, _inside(*GAN_GAPS), WAVE_RTOL[phase])


@pytest.mark.parametrize("phase", DEPLOYABLE)
def test_narrow_cnn_matches_jax(phase):
    jmodel, variables, model = _narrow_cnn()
    audio = _clips()
    want, got = _run_cnn(jmodel, variables, model, audio, CNN_GAPS, phase, GL_FEW)
    _check_cnn_composited(got[1], want[1], _cnn_hole_frames(CNN_GAPS))
    _check_wave(got[0], want[0], audio, _inside(*CNN_GAPS), WAVE_RTOL[phase])


def test_griffinlim_at_64_iterations_matches_jax():
    """The default ``gl_iters`` through both families (narrow models), on
    the gaps into the clip's end and of 0.5 s."""
    jcfg, cfg, jgen, variables, gen = _tiny_gan()
    audio = _clips(2)
    gaps = [(g[0][[1, 3]], g[1][[1, 3]]) for g in (GAN_GAPS, CNN_GAPS)]
    want, got = _run_gan(jgen, variables, gen, jcfg, cfg, audio, gaps[0], "griffinlim", 64)
    _check_gl64(got[0], want[0], audio, gaps[0], GAN_KW)
    jmodel, cvars, model = _narrow_cnn()
    want, got = _run_cnn(jmodel, cvars, model, audio, gaps[1], "griffinlim", 64)
    _check_gl64(got[0], want[0], audio, gaps[1], CNN_KW)


@pytest.mark.parametrize("phase", DEPLOYABLE)
def test_committed_checkpoints_match_jax(phase):
    """Both committed checkpoints at the default widths through their
    runners, two 1 s clips (Griffin-Lim at ``GL_FEW`` iterations)."""
    audio = _clips(2)
    gan_gaps = (GAN_GAPS[0][[1, 3]], GAN_GAPS[1][[1, 3]])
    jcfg, cfg = _gan_configs(tiny=False)
    runner = make_gan_runner(cfg, GAN_CKPT, device="cpu", mode="enhanced", phase=phase,
                             gl_iters=GL_FEW)
    want, got = _run_gan(jax_build_generator(jcfg), jax_load_npz(GAN_CKPT), runner.generator,
                         jcfg, cfg, audio, gan_gaps, phase, GL_FEW)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=GEN_ATOL_DEFAULT_WIDTH)
    _check_wave(got[0], want[0], audio, _inside(*gan_gaps), WAVE_RTOL[phase])
    np.testing.assert_array_equal(runner(audio, *gan_gaps).numpy(), got[0])

    cnn_gaps = (CNN_GAPS[0][[0, 2]], CNN_GAPS[1][[0, 2]])
    runner = make_cnn_runner(Config(), CNN_CKPT, device="cpu", phase=phase, gl_iters=GL_FEW)
    want, got = _run_cnn(JaxCNN(freq_bins=257), jax_load_npz(CNN_CKPT), runner.model, audio,
                         cnn_gaps, phase, GL_FEW)
    _check_cnn_composited(got[1], want[1], _cnn_hole_frames(cnn_gaps))
    _check_wave(got[0], want[0], audio, _inside(*cnn_gaps), WAVE_RTOL[phase])
    np.testing.assert_array_equal(runner(audio, *cnn_gaps).numpy(), got[0])


def test_runners_take_gl_iters():
    cfg = Config()
    audio = _clips(1)
    gaps = ([4000], [1280])
    runner = make_cnn_runner(cfg, CNN_CKPT, device="cpu", phase="griffinlim", gl_iters=3)
    args = (torch.tensor(audio), torch.tensor(gaps[0]), torch.tensor(gaps[1]))
    three = inference.make_cnn_inpaint_fn(cfg, runner.model, phase="griffinlim", gl_iters=3)
    one = inference.make_cnn_inpaint_fn(cfg, runner.model, phase="griffinlim", gl_iters=1)
    got = runner(audio, *gaps)
    torch.testing.assert_close(got, three(*args)[0], rtol=0, atol=0)
    assert not torch.equal(got, one(*args)[0])


def test_bf16_extrapolate_matches_jax_bf16():
    jcfg, cfg, jgen, variables, gen = _tiny_gan(seed=1)
    audio = _clips()
    want, got = _run_gan(jgen, variables, gen, jcfg, cfg, audio, GAN_GAPS, "extrapolate", GL_FEW,
                         jdtype=jnp.bfloat16, dtype=torch.bfloat16)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=BF16_GEN_ATOL)
    _check_wave(got[0], want[0], audio, _inside(*GAN_GAPS), BF16_WAVE_RTOL)


def _multi_masks(n, n_gaps=3, seed=5):
    """Seeded 1 = valid masks of ``n_gaps`` gaps a 1 s clip (``multi_gap_mask``
    with a 2048-sample spacing), and a last row with two gaps around a
    one-frame valid run."""
    g = torch.Generator().manual_seed(seed)
    u_len, u_pos = torch.rand(n, n_gaps, generator=g), torch.rand(n, n_gaps, generator=g)
    mask = multigap.multi_gap_mask(u_len, u_pos, SR, min_dist_samples=2048)[0].numpy()
    mask[-1] = 1.0
    mask[-1, 30 * GAN_HOP:40 * GAN_HOP - 256] = 0
    mask[-1, 40 * GAN_HOP + 256:50 * GAN_HOP] = 0
    return mask


@pytest.mark.parametrize("phase", ("oracle", *DEPLOYABLE))
def test_gan_mask_fn_matches_jax(phase):
    jcfg, cfg, jgen, variables, gen = _tiny_gan()
    audio, mask = _clips(), _multi_masks(4)
    jfn = jax_inference.make_gan_inpaint_mask_fn(jcfg, jgen, mode="enhanced", phase=phase,
                                                 gl_iters=GL_FEW)
    want = [np.asarray(w) for w in jfn(variables, jnp.asarray(audio), jnp.asarray(mask))]
    fn = inference.make_gan_inpaint_mask_fn(cfg, gen, mode="enhanced", phase=phase,
                                            gl_iters=GL_FEW)
    got = [g.numpy() for g in fn(torch.tensor(audio), torch.tensor(mask))]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=GEN_ATOL)
    if phase == "oracle":
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=WAVE_RTOL["extrapolate"])
    else:
        _check_wave(got[0], want[0], audio, mask < 0.5, WAVE_RTOL[phase])


def test_gan_mask_fn_bf16_matches_jax_bf16():
    jcfg, cfg, jgen, variables, gen = _tiny_gan(seed=1)
    audio, mask = _clips(), _multi_masks(4)
    jfn = jax_inference.make_gan_inpaint_mask_fn(jcfg, jgen, phase="extrapolate",
                                                 compute_dtype=jnp.bfloat16)
    want = [np.asarray(w) for w in jfn(variables, jnp.asarray(audio), jnp.asarray(mask))]
    fn = inference.make_gan_inpaint_mask_fn(cfg, gen, phase="extrapolate",
                                            compute_dtype=torch.bfloat16)
    got = [g.numpy() for g in fn(torch.tensor(audio), torch.tensor(mask))]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=BF16_GEN_ATOL)
    _check_wave(got[0], want[0], audio, mask < 0.5, BF16_WAVE_RTOL)


@pytest.mark.parametrize("phase", ("oracle", *DEPLOYABLE))
def test_cnn_mask_fn_matches_jax(phase):
    jmodel, variables, model = _narrow_cnn()
    audio, mask = _clips(), _multi_masks(4, seed=6)
    jfn = jax_inference.make_cnn_inpaint_mask_fn(JaxConfig(), jmodel, phase=phase,
                                                 gl_iters=GL_FEW)
    want = [np.asarray(w) for w in jfn(variables, jnp.asarray(audio), jnp.asarray(mask))]
    fn = inference.make_cnn_inpaint_mask_fn(Config(), model, phase=phase, gl_iters=GL_FEW)
    got = [g.numpy() for g in fn(torch.tensor(audio), torch.tensor(mask))]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-3)
    if phase == "oracle":
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=WAVE_RTOL["extrapolate"])
    else:
        _check_wave(got[0], want[0], audio, mask < 0.5, WAVE_RTOL[phase])


@pytest.mark.parametrize("phase", ("oracle", *DEPLOYABLE))
def test_one_gap_mask_is_the_interval_fn(phase):
    """The mask of one interval gives the interval functions' result, bit
    for bit: ``rule="any"`` is the GAN's floor/ceil frame rule and
    ``rule="end"`` the CNN+BiLSTM's floor/floor rule.  The masks come from
    ``eval_gap_table`` (``gap_len``/``gap_start`` of each row's gap)."""
    jcfg, cfg, jgen, variables, gen = _tiny_gan()
    audio = _clips(2)
    for fam, gaps, make_mask_fn, make_fn, net in (
        ("gan", GAN_GAPS, inference.make_gan_inpaint_mask_fn, inference.make_gan_inpaint_fn, gen),
        ("cnn", CNN_GAPS, inference.make_cnn_inpaint_mask_fn, inference.make_cnn_inpaint_fn,
         _narrow_cnn()[2]),
    ):
        for i in ((2,) if fam == "gan" else (3,)):  # one frame; 0.5 s
            masks, starts, lens = multigap.eval_gap_table(2, SR, int(gaps[1][i]), int(gaps[0][i]))
            kw = dict(mode="enhanced") if fam == "gan" else {}
            c = cfg if fam == "gan" else Config()
            a = make_mask_fn(c, net, phase=phase, gl_iters=2, **kw)(torch.tensor(audio),
                                                                     torch.tensor(masks))
            b = make_fn(c, net, phase=phase, gl_iters=2, **kw)(
                torch.tensor(audio), torch.tensor(starts, dtype=torch.int64),
                torch.tensor(lens, dtype=torch.int64))
            torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
            torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)


def test_mask_fns_check_their_options():
    _, cfg = _gan_configs(tiny=True)
    with pytest.raises(ValueError, match="enhanced"):
        inference.make_gan_inpaint_mask_fn(cfg, torch.nn.Identity(), mode="parity",
                                           phase="extrapolate")
    with pytest.raises(ValueError, match="phase must be"):
        inference.make_cnn_inpaint_mask_fn(Config(), torch.nn.Identity(), phase="magic")
    with pytest.raises(ValueError, match="compute_dtype"):
        inference.make_gan_inpaint_mask_fn(cfg, torch.nn.Identity(), compute_dtype=torch.half)


@pytest.mark.parametrize("n_shifts", [1, 4])
def test_tta_matches_jax(n_shifts):
    """Around the GAN under ``extrapolate``, a gap at sample 0 included (its
    shifted start lies below 0, the gap then covering ``[0, end - s)`` in
    both packages)."""
    jcfg, cfg, jgen, variables, gen = _tiny_gan()
    audio = _clips(2)
    gaps = (GAN_GAPS[0][[0, 2]], GAN_GAPS[1][[0, 2]])  # at sample 0; one frame
    jbase = jax_inference.make_gan_inpaint_fn(jcfg, jgen, mode="enhanced", phase="extrapolate")
    jtta = jax_inference.make_tta_shift_fn(jbase, GAN_HOP, n_shifts)
    want = [np.asarray(w) for w in jtta(variables, jnp.asarray(audio), jnp.asarray(gaps[0]),
                                        jnp.asarray(gaps[1]))]
    base = inference.make_gan_inpaint_fn(cfg, gen, mode="enhanced", phase="extrapolate")
    tta = inference.make_tta_shift_fn(base, GAN_HOP, n_shifts)
    args = (torch.tensor(audio), torch.tensor(gaps[0]), torch.tensor(gaps[1]))
    got = [g.numpy() for g in tta(*args)]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=GEN_ATOL)
    _check_wave(got[0], want[0], audio, _inside(*gaps), WAVE_RTOL["extrapolate"])
    if n_shifts == 1:
        torch.testing.assert_close(torch.tensor(got[0]), base(*args)[0], rtol=0, atol=0)
    else:
        assert not np.allclose(got[0], base(*args)[0].numpy())


def test_tta_rejects_zero_shifts():
    with pytest.raises(ValueError, match="n_shifts"):
        inference.make_tta_shift_fn(lambda *a: a, GAN_HOP, 0)


def test_cos2_fade_and_eval_gap_table_match_jax():
    for n in (1, 2, 32, 33):
        # two f32 ulps at 1.0: the libraries space linspace's points in other ways
        np.testing.assert_allclose(multigap.cos2_fade(n).numpy(),
                                   np.asarray(jax_multigap.cos2_fade(n)), rtol=0, atol=2.4e-7)
    got = multigap.eval_gap_table(3, 16000, 640, 5000)
    want = jax_multigap.eval_gap_table(3, 16000, 640, 5000)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fade_len", [32, 7])
def test_apply_gaps_with_fades_matches_jax(fade_len):
    """Three gaps a clip, one of them 5 samples from the clip's start (a
    fade cut by the edge), two whose ramps meet; batched in the port, one
    clip a call in JAX."""
    audio = _clips(2)
    starts = np.array([[5, 4000, 4040], [9000, 15990, 100]], np.int32)
    lens = np.array([[30, 20, 100], [1280, 10, 16]], np.int32)
    got = multigap.apply_gaps_with_fades(torch.tensor(audio), torch.tensor(starts),
                                         torch.tensor(lens), fade_len=fade_len).numpy()
    for b in range(2):
        want = np.asarray(jax_multigap.apply_gaps_with_fades(
            jnp.asarray(audio[b]), jnp.asarray(starts[b]), jnp.asarray(lens[b]),
            fade_len=fade_len))
        np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-6)
    inside = multigap.gaps_mask(SR, torch.tensor(starts), torch.tensor(lens)).numpy() < 0.5
    assert (got[inside] == 0).all()
    far = np.ones_like(inside)
    for b in range(2):
        for s, l in zip(starts[b], lens[b]):
            far[b, max(s - fade_len, 0):s + l + fade_len] = False
    np.testing.assert_array_equal(got[far], audio[far])

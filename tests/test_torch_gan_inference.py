"""The port's GAN serving function (``runtime/inference.py::make_gan_inpaint_fn``,
``runtime/serve.py::make_gan_runner``) against the JAX package's
``make_gan_inpaint_fn`` on the CPU, in both modes and both ported phase
regimes, from the same variables and clips.

The gaps of the batch cover the floor/ceil frame rule (frames
``[start // hop, ceil(end / hop))`` are holes): one starting mid-frame, one
on frame boundaries, one at the clip's start and one running into its end.
A frame mask one frame off would move the generator's output into the
composite, far above the tolerances.

Tolerances, each from what differs between the two packages:

* ``generated`` (the Tanh output, in [-1, 1]) in f32: ``atol=1e-5`` on the
  tiny generator (2.8e-6 seen), ``5e-5`` at the default widths (8.2e-6
  seen): sums of up to 9216 products in another order, through 14 layers.
* ``restored`` in f32: ``atol=2e-5`` on waveforms of peak ~1 (3.6e-7 seen):
  the FFTs' rounding and the generator's, through ``expm1`` in
  ``enhanced``.
* ``impaired``: outside the gap the input's own samples, exactly, in both
  packages.  Inside it the phase rules differ on the bins of frames lying
  wholly in the gap, which are exactly zero: an FFT returns some as -0.0,
  whose angle is pi, and which ones is up to the FFT library.  The JAX
  package keeps pi there, the port takes 0 at every zero bin.  So inside the
  gap the test rebuilds the reconstruction from JAX's ``generated`` with the
  JAX package's ops under both rules, and holds JAX's own ``restored`` to
  the sign-bit rule and the port's to the zero rule (1.2e-3 apart here).
* bf16 (``compute_dtype=torch.bfloat16`` against ``jnp.bfloat16``): both run
  every generator op in bf16 (8 bits of mantissa: 3.9e-3 at 1.0), and the
  two libraries round in other places (XLA's CPU convolutions and fusions
  keep some intermediates in f32).  ``generated`` within ``3e-2`` on the
  tiny generator (5.9e-3 seen against JAX's bf16, 1.25e-2 against the
  port's own f32, where JAX's bf16 lies 1.2e-2 from its f32) and ``6e-2``
  at the default widths (2.1e-2 seen against JAX's bf16, 2.0e-2 against
  f32); ``restored`` within ``1e-3`` (1.5e-4 and 2.8e-4 seen), ``impaired``
  held inside the gap to the zero-rule rebuild from JAX's bf16 output.
"""

import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.ops import masking as jax_masking
from ml_audio_inpainting_tpu.ops.gaps import frame_mask_from_interval as jax_frame_mask
from ml_audio_inpainting_tpu.ops.gaps import gap_mask as jax_gap_mask
from ml_audio_inpainting_tpu.ops.stft import istft as jax_istft
from ml_audio_inpainting_tpu.ops.stft import stft as jax_stft
from ml_audio_inpainting_tpu.runtime.inference import make_gan_inpaint_fn as jax_make_fn
from ml_audio_inpainting_tpu.train.checkpoints import load_params_npz as jax_load_npz
from ml_audio_inpainting_tpu.train.gan_trainer import build_generator as jax_build_generator
from ml_audio_inpainting_tpu.utils.config import Config as JaxConfig
from ml_audio_inpainting_tpu.utils.config import SpectrogramConfig as JaxSpectrogramConfig
from ml_audio_inpainting_torch.data.dataset import SyntheticSpeechDataset
from ml_audio_inpainting_torch.models.build import build_generator
from ml_audio_inpainting_torch.runtime.inference import make_gan_inpaint_fn
from ml_audio_inpainting_torch.runtime.serve import make_gan_runner
from ml_audio_inpainting_torch.utils.config import Config, SpectrogramConfig
from ml_audio_inpainting_torch.weights import pconv_unet_state_dict
from torch_threads import one_thread  # noqa: F401  (a module fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "results", "checkpoints", "gan_formant_v2_r2.npz")
HOP = 128
N_SAMPLES = 16000
# mid-frame start; frame-aligned start and end; at the clip's start; into its end
GAP_START = np.array([3000, 40 * HOP, 0, 15000])
GAP_LEN = np.array([1280, 8 * HOP, 500, 1000])
F32_ATOL = 2e-5
GEN_ATOL = 1e-5
GEN_ATOL_DEFAULT_WIDTH = 5e-5
BF16_GEN_ATOL = 3e-2
BF16_GEN_ATOL_DEFAULT_WIDTH = 6e-2
BF16_WAVE_ATOL = 1e-3
MODES = [("parity", "oracle"), ("enhanced", "oracle"), ("enhanced", "impaired")]


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, Mapping) else {key: np.asarray(v)})
    return out


def _configs(tiny: bool):
    """The JAX and port configs of the GAN profile (STFT 512/128/512, 1 s
    clips); ``tiny`` takes the narrow generator of ``tests/test_inference.py``."""
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


def _tiny(seed=0):
    """JAX generator and variables (redrawn so BatchNorm is no identity and
    the output is far from Tanh's saturation), the port's generator with the
    same weights, and both configs."""
    jcfg, cfg = _configs(tiny=True)
    jgen = jax_build_generator(jcfg)
    rng = np.random.default_rng(seed)
    variables = jax.jit(lambda k, a, m: jgen.init(k, a, m, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, 257, 126)), jnp.ones((1, 257, 126)))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.asarray(
            rng.uniform(0.5, 2.0, p.shape) if str(path[-1].key) == "var"
            else rng.standard_normal(p.shape) * 0.15, jnp.float32),
        variables,
    )
    gen = build_generator(cfg, device="cpu")
    gen.load_state_dict(pconv_unet_state_dict(_flatten(variables)))
    return jcfg, cfg, jgen, variables, gen


def _clips(n=4, seconds=1.0):
    ds = SyntheticSpeechDataset(n_items=n, max_len_s=seconds, seed=5)
    return np.stack([ds[i] for i in range(n)])


def _run_both(jcfg, cfg, jgen, variables, gen, audio, mode, phase, jax_dtype=None,
              torch_dtype=None, starts=GAP_START, lens=GAP_LEN):
    jfn = jax_make_fn(jcfg, jgen, mode=mode, phase=phase, compute_dtype=jax_dtype)
    want = jfn(variables, jnp.asarray(audio), jnp.asarray(starts), jnp.asarray(lens))
    fn = make_gan_inpaint_fn(cfg, gen, mode=mode, phase=phase, compute_dtype=torch_dtype)
    got = fn(torch.tensor(audio), torch.tensor(starts), torch.tensor(lens))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _impaired_rebuild(audio, generated, sign_bit_phase, starts=GAP_START, lens=GAP_LEN):
    """The ``enhanced``/``impaired`` reconstruction from ``generated`` with
    the JAX package's own ops: phase ``angle(spec_gap)`` on nonzero bins; on
    exactly zero bins, pi where ``sign_bit_phase`` and the real part's sign
    bit is set (the JAX package's rule), else 0 (the port's)."""
    kw = dict(n_fft=512, hop_length=HOP, win_length=512)
    n = audio.shape[-1]
    tmask = np.stack([np.asarray(jax_gap_mask(n, s, l)) for s, l in zip(starts, lens)])
    spec_gap = np.asarray(jax_stft(jnp.asarray(audio * tmask), **kw))
    fmask = np.stack([np.asarray(jax_frame_mask(s, s + l, 257, spec_gap.shape[-1], HOP))
                      for s, l in zip(starts, lens)])
    comp = jax_masking.composite(jnp.asarray(generated),
                                 jax_masking.log1p_norm(jnp.abs(jnp.asarray(spec_gap))),
                                 jnp.asarray(fmask))
    out_mag = np.asarray(jax_masking.log1p_denorm(comp))
    zero_phase = np.where(sign_bit_phase & np.signbit(spec_gap.real), np.pi, 0.0)
    phase = np.where(spec_gap == 0, zero_phase, np.angle(spec_gap))
    rec = np.asarray(jax_istft(jnp.asarray(out_mag * np.exp(1j * phase)), length=n, **kw))
    return audio * tmask + rec * (1.0 - tmask)


def _inside(n, starts=GAP_START, lens=GAP_LEN):
    idx = np.arange(n)
    return (idx >= starts[:, None]) & (idx < (starts + lens)[:, None])


def _check(want, got, audio, phase, starts=GAP_START, lens=GAP_LEN, gen_atol=GEN_ATOL,
           wave_atol=F32_ATOL):
    (want_r, want_g), (got_r, got_g) = want, got
    assert got_r.shape == want_r.shape == audio.shape
    assert got_g.shape == want_g.shape == (len(audio), 257, 1 + audio.shape[-1] // HOP)
    assert got_r.dtype == got_g.dtype == np.float32 and np.isfinite(got_g).all()
    np.testing.assert_allclose(got_g, want_g, rtol=0, atol=gen_atol)
    if phase == "oracle":
        np.testing.assert_allclose(got_r, want_r, rtol=0, atol=wave_atol)
        return
    inside = _inside(audio.shape[-1], starts, lens)
    np.testing.assert_array_equal(got_r[~inside], audio[~inside])
    np.testing.assert_array_equal(want_r[~inside], audio[~inside])
    jax_rule = _impaired_rebuild(audio, want_g, True, starts, lens)
    np.testing.assert_allclose(want_r[inside], jax_rule[inside], rtol=0, atol=F32_ATOL)
    port_rule = _impaired_rebuild(audio, want_g, False, starts, lens)
    np.testing.assert_allclose(got_r[inside], port_rule[inside], rtol=0, atol=wave_atol)


@pytest.mark.parametrize("mode,phase", MODES)
def test_tiny_generator_matches_jax(mode, phase):
    jcfg, cfg, jgen, variables, gen = _tiny()
    audio = _clips()
    want, got = _run_both(jcfg, cfg, jgen, variables, gen, audio, mode, phase)
    _check(want, got, audio, phase)


@pytest.mark.parametrize("mode,phase", MODES)
def test_committed_checkpoint_matches_jax(mode, phase):
    """The default-width generator with ``gan_formant_v2_r2.npz``, two 1.5 s
    clips (257 x 188, padded to 384 x 256)."""
    jcfg, cfg = _configs(tiny=False)
    audio = _clips(2, 1.5)
    starts, lens = np.array([8000, 20000]), np.array([1280, 1300])
    runner = make_gan_runner(cfg, CKPT, device="cpu", mode=mode, phase=phase)
    want, got = _run_both(jcfg, cfg, jax_build_generator(jcfg), jax_load_npz(CKPT),
                          runner.generator, audio, mode, phase, starts=starts, lens=lens)
    _check(want, got, audio, phase, starts, lens, gen_atol=GEN_ATOL_DEFAULT_WIDTH)
    restored = runner(audio, starts, lens)
    np.testing.assert_array_equal(restored.numpy(), got[0])


def test_committed_checkpoint_bf16_matches_jax_bf16():
    jcfg, cfg = _configs(tiny=False)
    audio = _clips(2, 1.5)
    starts, lens = np.array([8000, 20000]), np.array([1280, 1300])
    runner = make_gan_runner(cfg, CKPT, device="cpu", mode="enhanced",
                             compute_dtype=torch.bfloat16)
    want, got = _run_both(jcfg, cfg, jax_build_generator(jcfg), jax_load_npz(CKPT),
                          runner.generator, audio, "enhanced", "oracle", jax_dtype=jnp.bfloat16,
                          torch_dtype=torch.bfloat16, starts=starts, lens=lens)
    _check(want, got, audio, "oracle", starts, lens, gen_atol=BF16_GEN_ATOL_DEFAULT_WIDTH,
           wave_atol=BF16_WAVE_ATOL)
    np.testing.assert_array_equal(runner(audio, starts, lens).numpy(), got[0])


@pytest.mark.parametrize("mode,phase", MODES)
def test_bf16_matches_jax_bf16(mode, phase):
    """``compute_dtype=torch.bfloat16`` against the JAX function's
    ``jnp.bfloat16``, and against the port's own f32 result; the generator
    passed in keeps its f32 weights."""
    jcfg, cfg, jgen, variables, gen = _tiny(seed=1)
    audio = _clips()
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    want, got = _run_both(jcfg, cfg, jgen, variables, gen, audio, mode, phase,
                          jax_dtype=jnp.bfloat16, torch_dtype=torch.bfloat16)
    _check(want, got, audio, phase, gen_atol=BF16_GEN_ATOL, wave_atol=BF16_WAVE_ATOL)
    got_g = got[1]
    f32 = make_gan_inpaint_fn(cfg, gen, mode=mode, phase=phase)(
        torch.tensor(audio), torch.tensor(GAP_START), torch.tensor(GAP_LEN))
    np.testing.assert_allclose(got_g, f32[1].numpy(), rtol=0, atol=BF16_GEN_ATOL)
    assert np.abs(got_g - f32[1].numpy()).max() > 1e-3  # the bf16 path did run in bf16
    for k, v in gen.state_dict().items():
        assert v.dtype == before[k].dtype
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_bf16_copy_runs_every_generator_op_in_bf16(monkeypatch):
    """Every convolution of the bf16 path gets bf16 inputs and weights and
    gives a bf16 result (the port's convolution, ``utils/precision.py::conv``,
    computes a bf16 convolution on the CPU as the f32 convolution of those
    bf16 values, rounded to bf16: oneDNN's bf16 kernels can leave outputs
    unwritten, ``tests/test_torch_conv_bf16.py``)."""
    from ml_audio_inpainting_torch.utils import precision

    jcfg, cfg, jgen, variables, gen = _tiny()
    seen = []
    conv = precision.conv

    def spy(x, w, *args, **kwargs):
        out = conv(x, w, *args, **kwargs)
        seen.append((x.dtype, w.dtype, out.dtype))
        return out

    fn = make_gan_inpaint_fn(cfg, gen, mode="enhanced", compute_dtype=torch.bfloat16)
    monkeypatch.setattr(precision, "conv", spy)
    fn(torch.tensor(_clips(1)), torch.tensor(GAP_START[:1]), torch.tensor(GAP_LEN[:1]))
    # 3 encoder, 2 decoder and 2 final partial convs
    assert len([s for s in seen if s[1] == torch.bfloat16]) >= 7
    assert all(s == (torch.bfloat16,) * 3 for s in seen)


def test_impaired_keeps_the_input_outside_the_gap():
    jcfg, cfg, jgen, variables, gen = _tiny()
    audio = _clips()
    restored, _ = make_gan_inpaint_fn(cfg, gen, mode="enhanced", phase="impaired")(
        torch.tensor(audio), torch.tensor(GAP_START), torch.tensor(GAP_LEN))
    inside = _inside(N_SAMPLES)
    np.testing.assert_array_equal(restored.numpy()[~inside], audio[~inside])
    assert not np.array_equal(restored.numpy()[inside], audio[inside])


def test_zero_bins_take_phase_zero():
    """The recorded rule: the impaired reconstruction is the rebuild with
    phase 0 on every exactly-zero bin of the gapped STFT, and the gap of the
    first clip (10 frames wholly inside it) has such bins."""
    jcfg, cfg, jgen, variables, gen = _tiny()
    audio = _clips()
    restored, generated = make_gan_inpaint_fn(cfg, gen, mode="enhanced", phase="impaired")(
        torch.tensor(audio), torch.tensor(GAP_START), torch.tensor(GAP_LEN))
    rebuilt = _impaired_rebuild(audio, generated.numpy(), sign_bit_phase=False)
    np.testing.assert_allclose(restored.numpy(), rebuilt, rtol=0, atol=F32_ATOL)
    kw = dict(n_fft=512, hop_length=HOP, win_length=512)
    tmask = np.stack([np.asarray(jax_gap_mask(N_SAMPLES, s, l)) for s, l in zip(GAP_START, GAP_LEN)])
    assert (np.asarray(jax_stft(jnp.asarray(audio * tmask), **kw))[0] == 0).any()


def test_parity_feeds_the_log1p_output_to_the_istft():
    """``parity`` rebuilds from the generator's output as a magnitude with
    the clean phase, no ``expm1`` and no composite, as the reference does."""
    jcfg, cfg, jgen, variables, gen = _tiny()
    audio = _clips(2)
    restored, generated = make_gan_inpaint_fn(cfg, gen, mode="parity")(
        torch.tensor(audio), torch.tensor(GAP_START[:2]), torch.tensor(GAP_LEN[:2]))
    kw = dict(n_fft=512, hop_length=HOP, win_length=512)
    spec = np.asarray(jax_stft(jnp.asarray(audio), **kw))
    want = np.asarray(jax_istft(jnp.asarray(generated.numpy() * np.exp(1j * np.angle(spec))),
                                length=N_SAMPLES, **kw))
    np.testing.assert_allclose(restored.numpy(), want, rtol=0, atol=F32_ATOL)


def test_training_generator_is_served_in_eval_mode():
    """A generator left in train mode is applied with BatchNorm's running
    statistics, as the JAX function applies it with ``train=False``; its
    mode and statistics are left as they were."""
    jcfg, cfg, jgen, variables, gen = _tiny()
    audio = _clips()
    gen.train()
    stats = {k: v.clone() for k, v in gen.state_dict().items()
             if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    want, got = _run_both(jcfg, cfg, jgen, variables, gen, audio, "enhanced", "oracle")
    _check(want, got, audio, "oracle")
    assert gen.training
    for k, v in stats.items():
        torch.testing.assert_close(gen.state_dict()[k], v, rtol=0, atol=0)
    bf16 = make_gan_inpaint_fn(cfg, gen, mode="enhanced", compute_dtype=torch.bfloat16)
    bf16(torch.tensor(audio), torch.tensor(GAP_START), torch.tensor(GAP_LEN))
    assert gen.training


def test_later_options_raise():
    """The options no path serves raise.  The deployable regimes
    ``extrapolate`` and ``griffinlim``, ported since, build in ``enhanced``
    mode and, as ``impaired``, refuse ``parity``."""
    _, cfg = _configs(tiny=True)
    gen = torch.nn.Identity()
    for phase in ("extrapolate", "griffinlim"):
        assert callable(make_gan_inpaint_fn(cfg, gen, mode="enhanced", phase=phase))
    for phase in ("impaired", "extrapolate", "griffinlim"):
        with pytest.raises(ValueError, match="require mode='enhanced'"):
            make_gan_inpaint_fn(cfg, gen, mode="parity", phase=phase)
    with pytest.raises(ValueError, match="phase must be one of"):
        make_gan_inpaint_fn(cfg, gen, mode="enhanced", phase="magic")
    with pytest.raises(ValueError, match="mode must be"):
        make_gan_inpaint_fn(cfg, gen, mode="fast")
    with pytest.raises(ValueError, match="compute_dtype"):
        make_gan_inpaint_fn(cfg, gen, compute_dtype=torch.float16)


def test_runner_checks_its_checkpoint_and_config():
    _, cfg = _configs(tiny=True)
    with pytest.raises(RuntimeError, match="size mismatch"):
        make_gan_runner(cfg, CKPT, device="cpu")
    with pytest.raises(ValueError, match="npz"):  # .pt and directories are served now
        make_gan_runner(Config(), "generator.bin", device="cpu")


def test_runner_bf16_keeps_its_generator_f32():
    _, cfg = _configs(tiny=False)
    runner = make_gan_runner(cfg, CKPT, device="cpu", compute_dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in runner.generator.parameters())
    assert not runner.generator.training
    audio = _clips(1, 0.5)
    restored = runner(audio, [2000], [1280])
    assert restored.dtype == torch.float32 and restored.shape == (1, 8000)
    assert torch.isfinite(restored).all()


def test_entry_points_default_to_cuda():
    import inspect

    for fn in (make_gan_runner, build_generator):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            make_gan_runner(Config(), CKPT)

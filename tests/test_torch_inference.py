"""The port's CNN+BiLSTM serving path (``runtime/inference.py``,
``runtime/serve.py``, ``utils/config.py``) against the JAX package's
``make_cnn_inpaint_fn`` on the CPU, in the ``oracle`` and ``impaired``
phase regimes.

The gaps of the batch cover the frame-mask floor rule (frames
``[start // hop, (start + len) // hop)`` are the gap): one starting
mid-frame, one on frame boundaries, one at the clip's start and one running
into its end.  A frame mask one frame off would move an O(1) prediction into
``composited``, far above the tolerances.

Tolerances, each from what differs between the two packages:

* ``composited`` (log10 magnitudes, -9..3) on the gap frames, the model's
  prediction: ``atol=5e-5``.  Elsewhere it is ``log10(|S| + 1e-9)`` of the
  input, and on bins some 1e4 below their frame's peak the two FFTs' f32
  rounding is relatively large: ``atol=1e-3`` there (3.3e-4 seen).
* ``restored``: ``atol=2e-5`` on waveforms of peak ~1 to 2.  The random
  narrow model predicts in-gap magnitudes up to ~60, which scale its
  prediction's rounding into the waveform (8.7e-6 seen; 4e-7 with the
  committed weights).
* ``restored``, ``impaired``: the input's own samples outside the gap, in
  both packages exactly.  Inside the gap the phase rules differ on one set
  of bins: those of frames lying wholly in the gap are exactly zero, and an
  FFT returns some of them as -0.0, whose angle is pi.  Which ones is up to
  the FFT library; the JAX package keeps pi there, the port gives every zero
  bin phase 0.  So inside the gap the test rebuilds the reconstruction from
  JAX's ``composited`` with the JAX package's ops under both rules, and
  holds JAX's own ``restored`` to the sign-bit rule and the port's to the
  zero rule, each at ``atol=2e-5`` (1.5e-7 and 8.3e-7 seen; the two rules
  are 0.047 apart on the narrow model, 2.9e-4 with the committed weights).
"""

import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.models.cnn_blstm import StackedBLSTMCNN as JaxCNN
from ml_audio_inpainting_tpu.ops.gaps import gap_mask as jax_gap_mask
from ml_audio_inpainting_tpu.ops.stft import istft as jax_istft
from ml_audio_inpainting_tpu.ops.stft import stft as jax_stft
from ml_audio_inpainting_tpu.runtime.inference import make_cnn_inpaint_fn as jax_make_fn
from ml_audio_inpainting_tpu.train.checkpoints import load_params_npz as jax_load_npz
from ml_audio_inpainting_tpu.utils.config import Config as JaxConfig
from ml_audio_inpainting_tpu.utils.config import load_config as jax_load_config
from ml_audio_inpainting_torch.ops.stft import stft
from ml_audio_inpainting_torch.runtime.inference import make_cnn_inpaint_fn
from ml_audio_inpainting_torch.runtime.serve import make_cnn_runner
from ml_audio_inpainting_torch.runtime import synthetic
from ml_audio_inpainting_torch.train.cnn_trainer import create_cnn_state
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.weights import cnn_blstm_from_numpy, load_params_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "results", "checkpoints", "cnn_blstm_formant_v2_r2.npz")
HOP = 192
# mid-frame start; frame-aligned start and end; at the clip's start; into its end
GAP_START = np.array([3000, 16 * HOP, 0, 15000])
GAP_LEN = np.array([1280, 8 * HOP, 500, 1000])
N_SAMPLES = 16000


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, Mapping) else {key: np.asarray(v)})
    return out


def _clips(speech_like):
    """Four 1 s clips cut from the 5 s speech-like fixture."""
    return np.stack([speech_like[i * N_SAMPLES : (i + 1) * N_SAMPLES] for i in range(4)])


def _narrow_model(rng):
    jmodel = JaxCNN(num_lstm_layers=2, lstm_hidden_dim=16, freq_bins=257,
                    enc_filters=(4, 8), dec_filters=(4, 8))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 257, 84)), train=False)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.asarray(
            rng.uniform(0.5, 2.0, p.shape) if str(path[-1].key) == "var"
            else rng.standard_normal(p.shape) * 0.2,
            jnp.float32,
        ),
        variables,
    )
    return jmodel, variables


def _jax_vs_port(jmodel, variables, model, audio, phase):
    jfn = jax_make_fn(JaxConfig(), jmodel, phase=phase)
    want = jfn(variables, jnp.asarray(audio), jnp.asarray(GAP_START), jnp.asarray(GAP_LEN))
    fn = make_cnn_inpaint_fn(Config(), model, phase=phase)
    got = fn(torch.tensor(audio), torch.tensor(GAP_START), torch.tensor(GAP_LEN))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _impaired_rebuild(audio, composited, sign_bit_phase):
    """The ``impaired`` reconstruction from ``composited`` with the JAX
    package's own ops: phase ``angle(spec_gap)`` on nonzero bins; on bins where
    the gapped spectrum is exactly zero, phase pi where ``sign_bit_phase`` and
    the real part's sign bit is set (``angle(-0.0) = pi``, the JAX package's
    rule), else 0 (the port's rule; see the module docstring)."""
    kw = dict(n_fft=512, hop_length=HOP, win_length=384)
    tmask = np.stack([np.asarray(jax_gap_mask(audio.shape[-1], s, l)) for s, l in zip(GAP_START, GAP_LEN)])
    spec_gap = np.asarray(jax_stft(jnp.asarray(audio * tmask), **kw))
    zero_phase = np.where(sign_bit_phase & np.signbit(spec_gap.real), np.pi, 0.0)
    phase = np.where(spec_gap == 0, zero_phase, np.angle(spec_gap))
    rec = jax_istft(jnp.asarray(10.0 ** composited * np.exp(1j * phase)), length=audio.shape[-1], **kw)
    return audio * tmask + np.asarray(rec) * (1.0 - tmask)


def _check(want, got, audio, phase):
    (want_r, want_c), (got_r, got_c) = want, got
    assert got_r.shape == want_r.shape == audio.shape
    assert got_c.shape == want_c.shape == (len(audio), 257, 84)
    frames = np.arange(got_c.shape[-1])
    hole = (frames >= GAP_START[:, None] // HOP) & (frames < (GAP_START + GAP_LEN)[:, None] // HOP)
    np.testing.assert_allclose(got_c.transpose(0, 2, 1)[hole], want_c.transpose(0, 2, 1)[hole],
                               rtol=0, atol=5e-5)
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-3)
    if phase == "oracle":
        np.testing.assert_allclose(got_r, want_r, rtol=0, atol=2e-5)
        return
    idx = np.arange(audio.shape[-1])
    inside = (idx >= GAP_START[:, None]) & (idx < (GAP_START + GAP_LEN)[:, None])
    np.testing.assert_array_equal(got_r[~inside], audio[~inside])
    np.testing.assert_array_equal(want_r[~inside], audio[~inside])
    # The witness: the JAX package's own output is the rebuild with phase pi
    # on exactly the zero bins whose sign bit is set, so that rule is the
    # whole of the difference to the port inside the gap.
    jax_rule = _impaired_rebuild(audio, want_c, sign_bit_phase=True)
    np.testing.assert_allclose(want_r[inside], jax_rule[inside], rtol=0, atol=2e-5)
    port_rule = _impaired_rebuild(audio, want_c, sign_bit_phase=False)
    np.testing.assert_allclose(got_r[inside], port_rule[inside], rtol=0, atol=2e-5)


@pytest.mark.parametrize("phase", ["oracle", "impaired"])
def test_narrow_model_matches_jax(speech_like, phase):
    audio = _clips(speech_like)
    jmodel, variables = _narrow_model(np.random.default_rng(21))
    model = cnn_blstm_from_numpy(_flatten(variables), device="cpu")
    want, got = _jax_vs_port(jmodel, variables, model, audio, phase)
    _check(want, got, audio, phase)


@pytest.mark.parametrize("phase", ["oracle", "impaired"])
def test_committed_checkpoint_matches_jax(speech_like, phase):
    audio = _clips(speech_like)
    model = cnn_blstm_from_numpy(load_params_npz(CKPT), device="cpu")
    want, got = _jax_vs_port(JaxCNN(freq_bins=257), jax_load_npz(CKPT), model, audio, phase)
    _check(want, got, audio, phase)


def test_training_model_is_served_in_eval_mode(speech_like):
    """A model fresh from ``create_cnn_state`` is in train mode.  The inpaint
    fn still applies it with BatchNorm's running statistics, as the JAX
    function applies the same variables with ``train=False``, and leaves
    the running statistics and the model's mode as they were.  (Applied in
    train mode, the batch's statistics would replace the running ones, which
    ``_narrow_model`` draws far from any batch's, and move them.)"""
    audio = _clips(speech_like)
    jmodel, variables = _narrow_model(np.random.default_rng(22))
    cfg = Config.from_dict({"model": {"num_lstm_layers": 2, "lstm_hidden_dim": 16,
                                      "enc_filters": [4, 8], "dec_filters": [4, 8]}})
    model = create_cnn_state(cfg, device="cpu", params=_flatten(variables)).model
    assert model.training
    stats = {k: v.clone() for k, v in model.state_dict().items() if k.endswith(("_mean", "_var"))}
    assert stats
    want, got = _jax_vs_port(jmodel, variables, model, audio, "oracle")
    _check(want, got, audio, "oracle")
    assert model.training
    for k, v in stats.items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)


def test_frame_mask_floor_rule(speech_like):
    """``composited`` is the model's prediction exactly on frames
    ``[s // hop, (s + l) // hop)`` and the input's log magnitude elsewhere."""
    audio = _clips(speech_like)
    model = cnn_blstm_from_numpy(_flatten(_narrow_model(np.random.default_rng(3))[1]), device="cpu")
    _, comp_o = make_cnn_inpaint_fn(Config(), model, "oracle")(
        torch.tensor(audio), torch.tensor(GAP_START), torch.tensor(GAP_LEN)
    )
    log_in = torch.log10(stft(torch.tensor(audio), 512, 192, 384).abs() + 1e-9)
    for b in range(len(audio)):
        lo, hi = GAP_START[b] // HOP, (GAP_START[b] + GAP_LEN[b]) // HOP
        frames = np.arange(84)
        outside = (frames < lo) | (frames >= hi)
        torch.testing.assert_close(comp_o[b][:, outside], log_in[b][:, outside], rtol=0, atol=0)
        assert not torch.allclose(comp_o[b][:, lo:hi], log_in[b][:, lo:hi])


def test_runner_matches_inpaint_fn(speech_like):
    cfg = Config()
    audio = _clips(speech_like)[:2]
    runner = make_cnn_runner(cfg, CKPT, device="cpu")
    restored = runner(audio, GAP_START[:2], GAP_LEN[:2])
    want, _ = runner.inpaint_fn(torch.tensor(audio), torch.tensor(GAP_START[:2]),
                                torch.tensor(GAP_LEN[:2]))
    torch.testing.assert_close(restored, want, rtol=0, atol=0)
    assert restored.device.type == "cpu" and runner.cfg is cfg


def test_runner_rejects_mismatched_config_and_formats():
    cfg = Config()
    cfg.model.cnn_blstm.lstm_hidden_dim = 64
    with pytest.raises(RuntimeError, match="size mismatch"):
        make_cnn_runner(cfg, CKPT, device="cpu")
    with pytest.raises(ValueError, match="npz"):  # .pt and directories are served now
        make_cnn_runner(Config(), "weights.bin", device="cpu")


@pytest.mark.parametrize("phase", ["extrapolate", "griffinlim"])
def test_later_phase_regimes_raise(phase):
    """Once later, these regimes are ported now: they build and serve (the
    identity as the model: its input, the gapped log magnitude, is its
    prediction), keeping every sample outside the gap."""
    fn = make_cnn_inpaint_fn(Config(), torch.nn.Identity(), phase=phase, gl_iters=2)
    audio = torch.tensor(np.random.default_rng(4).standard_normal((2, N_SAMPLES)), dtype=torch.float32)
    restored, _ = fn(audio, torch.tensor(GAP_START[:2]), torch.tensor(GAP_LEN[:2]))
    idx = np.arange(N_SAMPLES)
    inside = (idx >= GAP_START[:2, None]) & (idx < (GAP_START + GAP_LEN)[:2, None])
    assert torch.isfinite(restored).all()
    np.testing.assert_array_equal(restored.numpy()[~inside], audio.numpy()[~inside])


def test_unknown_phase_raises():
    with pytest.raises(ValueError, match="phase must be one of"):
        make_cnn_inpaint_fn(Config(), torch.nn.Identity(), phase="magic")


def test_config_matches_jax():
    """Defaults and ``configs/cnn_blstm.yaml`` load to the same fields."""
    for port, ref in (
        (Config(), JaxConfig()),
        (Config.from_yaml(os.path.join(REPO, "configs", "cnn_blstm.yaml")),
         jax_load_config(os.path.join(REPO, "configs", "cnn_blstm.yaml"))),
    ):
        assert port.to_dict()["data"] == ref.to_dict()["data"]
        assert port.to_dict()["model"]["cnn_blstm"] == ref.to_dict()["model"]["cnn_blstm"]
        spec = port.data.spectrogram
        assert spec.freq_bins == ref.data.spectrogram.freq_bins == 257
        assert spec.frames(80000) == ref.data.spectrogram.frames(80000) == 417


def test_synthetic_request_batch_is_seeded():
    """The request ``chip_smoke.py`` and the profile script serve: seeded,
    f32 rows of peak 1 that differ from each other, and a gap inside them."""
    a = synthetic.speech_like_batch(np.random.default_rng(1), 3)
    b = synthetic.speech_like_batch(np.random.default_rng(1), 3)
    assert a.shape == (3, 5 * synthetic.SAMPLE_RATE) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(np.abs(a).max(axis=1), 1.0, rtol=1e-6)
    assert not np.allclose(a[0], a[1])
    assert 0 < synthetic.GAP_START < synthetic.GAP_START + synthetic.GAP_LEN < a.shape[1]
    assert synthetic.BATCH == 32

"""The phase-mode (complex 2-channel) and global-pool CNN+BiLSTM in the port
against the JAX package on the CPU: the two model variants (forward and
gradients), ``cnn_phase_features`` plain and anchored, the complex L1 loss
and its gradient at exact zeros, and ``make_cnn_phase_inpaint_fn`` plain and
anchored.  The phase-mode steps are ``tests/test_torch_phase_train.py``'s.

Narrow models (enc [4, 8], hidden 16, 2 layers; 0.5 s clips, 257 x 42)
with every leaf redrawn from a seeded numpy generator
(``tests/test_torch_cnn_train.py::_redraw``); gap positions are JAX's, from
its key (``_starts_of_key``).  Tolerances, every sum in another order:

* model outputs (and ``reconstruct_spectrogram``'s composite, the input's
  bins outside the gap bit for bit): atol 5e-5 on outputs of order 1 (as the
  full-width forward of ``tests/test_torch_cnn_blstm.py``); gradients as the f32 step
  of ``tests/test_torch_cnn_train.py`` (per tensor, max error within 1e-4
  of the tensor's largest entry); the loss to rtol 1e-6 (as the magnitude
  loss there);
* features: ``spec_gap`` and the plain ``target`` atol 1e-4 (STFT bins up
  to ~1e2, as ``tests/test_torch_dsp.py``), the gap mask exact; the
  anchored target atol 1e-3: the anchor is the phase of the gapped STFT
  carried across the gap, and where a bin is quiet at the gap's edge the
  two FFTs' rounding moves its phase by more than their relative 1e-7,
  which the rotation then lays onto the clean bin's full magnitude;
* served waveforms: equal outside the gap bit for bit (the time composite
  keeps the input), inside within 1e-4 (plain) and 2e-3 (anchored, the
  anchor's rounding as above; the bound of
  ``tests/test_torch_deployable_inference.py``) of the gap's peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.models.cnn_blstm import StackedBLSTMCNN as JaxCNN
from ml_audio_inpainting_tpu.runtime import inference as jax_inference
from ml_audio_inpainting_tpu.train import cnn_trainer as jax_trainer
from ml_audio_inpainting_tpu.train import features as jax_features
from ml_audio_inpainting_tpu.train.losses import cnn_phase_l1_loss as jax_phase_l1
from ml_audio_inpainting_tpu.utils.config import Config as JaxConfig
from ml_audio_inpainting_torch.runtime.inference import make_cnn_phase_inpaint_fn
from ml_audio_inpainting_torch.train.features import cnn_phase_features
from ml_audio_inpainting_torch.train.losses import cnn_phase_l1_loss
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.weights import cnn_blstm_flat_variables, cnn_blstm_from_numpy
from test_torch_cnn_train import (
    CLIPS,
    GAP_S,
    N_SAMPLES,
    SR,
    VARIANTS,
    _assert_grads_close,
    _audio,
    _cfg_dict,
    _redraw,
    _starts_of_key,
    flatten,
)

N_FRAMES = 1 + N_SAMPLES // 192


def _phase_cfg_dict(**kw):
    d = _cfg_dict(**kw)
    d["model"] = {**d["model"], "in_channels": 2}
    return d


@pytest.mark.parametrize("variant", ["phase", "global_pool"])
def test_variant_forward_and_gradients_match_jax(variant):
    """Eval- and train-mode outputs, and the gradients of a fixed linear
    function of the train-mode output, of the phase-mode model (``(B, F,
    T, 2)`` in and out) and of the global-pool model, loaded through
    ``cnn_blstm_from_numpy`` (which reads the variant off the weights)."""
    kw = dict(in_channels=2) if variant == "phase" else dict(global_pool=True)
    net = JaxCNN(num_lstm_layers=2, lstm_hidden_dim=16, freq_bins=257, enc_filters=(4, 8),
                 dec_filters=(4, 8), **kw)
    rng = np.random.default_rng(2)
    shape = (2, 257, N_FRAMES) + ((2,) if variant == "phase" else ())
    x = rng.standard_normal(shape).astype(np.float32)
    variables = jax.jit(lambda k, a: net.init(k, a, train=False))(jax.random.PRNGKey(0),
                                                                   jnp.asarray(x))
    variables = _redraw(variables, rng)
    model = cnn_blstm_from_numpy(flatten(variables), device="cpu")
    assert model.in_channels == (2 if variant == "phase" else 1)
    assert model.global_pool == (variant == "global_pool")
    assert model.lstm.l0_fwd_w_ih.shape[0] == (8 * 257 * 2 // 2 if variant == "phase" else 8)

    want_eval = np.asarray(jax.jit(lambda v, a: net.apply(v, a, train=False))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got_eval = model(torch.tensor(x)).numpy()
    assert got_eval.shape == want_eval.shape == shape
    np.testing.assert_allclose(got_eval, want_eval, rtol=0, atol=5e-5)
    # reconstruct_spectrogram: the prediction in the gap, the input elsewhere
    # (complex in phase mode), as JAX's composes it (cnn_blstm.py:99-115).
    gm = np.zeros((2, 257, N_FRAMES), np.float32)
    gm[:, :, 10:14] = 1.0
    got_rec = model.reconstruct_spectrogram(torch.tensor(x), torch.tensor(gm)).detach().numpy()
    if variant == "phase":
        want_rec = ((want_eval[..., 0] + 1j * want_eval[..., 1]) * gm
                    + (x[..., 0] + 1j * x[..., 1]) * (1 - gm))
    else:
        want_rec = want_eval * gm + x * (1 - gm)
    np.testing.assert_allclose(got_rec, want_rec, rtol=0, atol=5e-5)
    np.testing.assert_array_equal(got_rec[:, :, :10], want_rec[:, :, :10])

    w = rng.standard_normal(shape).astype(np.float32)

    def jax_loss(params):
        out, _ = net.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), out

    (_, want_train), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        variables["params"])
    model.train()
    out = model(torch.tensor(x))
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_train), rtol=0, atol=5e-5)
    got = cnn_blstm_flat_variables({n: p.grad for n, p in model.named_parameters()})
    _assert_grads_close(got, flatten({"params": grads}))


@pytest.mark.parametrize("anchored", [False, True], ids=["plain", "anchored"])
def test_cnn_phase_features_match_jax(anchored):
    spec_cfg = JaxConfig().data.spectrogram
    audio = _audio(0)
    key = jax.random.PRNGKey(7)
    want = jax_features.cnn_phase_features(
        jnp.asarray(audio), key, spec_cfg, gap_len_s=GAP_S, sample_rate=SR,
        n_samples=N_SAMPLES, gaps_per_audio=VARIANTS, anchored=anchored)
    got = cnn_phase_features(torch.tensor(audio), _starts_of_key(key),
                             Config().data.spectrogram, gap_len_s=GAP_S, sample_rate=SR,
                             anchored=anchored)
    assert set(got) == set(want) == {"spec_gap", "gap_mask", "target"}
    assert got["spec_gap"].shape == want["spec_gap"].shape == (CLIPS * VARIANTS, 257,
                                                               N_FRAMES, 2)
    np.testing.assert_array_equal(got["gap_mask"].numpy(), np.asarray(want["gap_mask"]))
    assert got["gap_mask"].any()
    np.testing.assert_allclose(got["spec_gap"].numpy(), np.asarray(want["spec_gap"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["target"].numpy(), np.asarray(want["target"]), rtol=0,
                               atol=1e-3 if anchored else 1e-4)


def test_cnn_phase_l1_loss_and_its_gradient_at_zeros_match_jax():
    """The loss and its gradient, with exact zeros of the complex error
    both outside the gap (mask 0) and inside it (prediction equal to the
    target): 0 there in both packages, never NaN."""
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((3, 17, 9, 2)).astype(np.float32)
    target = (rng.standard_normal((3, 17, 9)) + 1j * rng.standard_normal((3, 17, 9))).astype(
        np.complex64)
    target[0, :4] = pred[0, :4, :, 0] + 1j * pred[0, :4, :, 1]  # exact zeros in the gap
    mask = (rng.uniform(size=(3, 17, 9)) < 0.5).astype(np.float32)
    mask[0, :4] = 1.0
    want, want_grad = jax.value_and_grad(jax_phase_l1)(jnp.asarray(pred), jnp.asarray(target),
                                                      jnp.asarray(mask))
    p = torch.tensor(pred, requires_grad=True)
    got = cnn_phase_l1_loss(p, torch.tensor(target), torch.tensor(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert torch.isfinite(p.grad).all()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-7)
    zero = (mask == 0)[..., None] | np.zeros((1, 1, 1, 2), bool)
    zero[0, :4] = True
    assert not p.grad.numpy()[zero].any()


@pytest.mark.parametrize("anchored", [False, True], ids=["plain", "anchored"])
def test_phase_inpaint_fn_matches_jax(anchored):
    jcfg = JaxConfig.from_dict(_phase_cfg_dict())
    net = jax_trainer.build_model(jcfg)
    rng = np.random.default_rng(4)
    variables = jax.jit(lambda k, a: net.init(k, a, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 257, N_FRAMES, 2)))
    variables = _redraw(variables, rng)
    audio = _audio(6)
    gs = np.array([2000, 6000])
    gl = np.array([800, 1200])
    want, want_c = jax_inference.make_cnn_phase_inpaint_fn(jcfg, net, anchored=anchored)(
        variables, jnp.asarray(audio), jnp.asarray(gs), jnp.asarray(gl))
    model = cnn_blstm_from_numpy(flatten(variables), device="cpu")
    got, got_c = make_cnn_phase_inpaint_fn(Config.from_dict(_phase_cfg_dict()), model,
                                           anchored=anchored)(
        torch.tensor(audio), torch.tensor(gs), torch.tensor(gl))
    assert got_c.dtype == torch.complex64 and got_c.shape == want_c.shape
    idx = np.arange(N_SAMPLES)
    inside = (idx >= gs[:, None]) & (idx < (gs + gl)[:, None])
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy()[~inside], audio[~inside])
    np.testing.assert_array_equal(want[~inside], audio[~inside])
    peak = np.abs(want[inside]).max()
    err = np.abs(got.numpy()[inside] - want[inside]).max()
    assert err <= (2e-3 if anchored else 1e-4) * peak, (err, peak)

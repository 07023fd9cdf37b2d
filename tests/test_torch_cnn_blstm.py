"""The port's ``StackedBLSTMCNN`` and weight carrying
(``ml_audio_inpainting_torch/models/cnn_blstm.py``, ``weights.py``) against
the flax model.

* A narrow random-init model (enc [4, 8], hidden 16, 1 and 2 layers), its
  flax variables flattened to ``/``-joined keys and carried across.
  Tolerance ``atol=1e-5`` on outputs of order 1: three conv layers, the
  BiLSTM and the projection, each summed in another order.
* The committed ``results/checkpoints/cnn_blstm_formant_v2_r2.npz`` at full
  width on one 1 s clip (257x84): the layer-0 input projection sums 16448
  products per gate.  Tolerance ``atol=5e-5`` on outputs in about -2.3..0.4
  (the difference seen on the CPU is 1.5e-6).
"""

import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.models.cnn_blstm import StackedBLSTMCNN as JaxCNN
from ml_audio_inpainting_tpu.ops.stft import stft as jax_stft
from ml_audio_inpainting_tpu.train.checkpoints import load_params_npz as jax_load_npz
from ml_audio_inpainting_torch.models.build import build_model
from ml_audio_inpainting_torch.models.cnn_blstm import StackedBLSTMCNN
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.weights import (
    cnn_blstm_from_numpy,
    cnn_blstm_state_dict,
    load_params_npz,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "results", "checkpoints", "cnn_blstm_formant_v2_r2.npz")


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _random_variables(model, x, rng):
    """flax init, then every leaf replaced by seeded values (positive
    variances) so biases, BN affines and running stats all matter."""
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)

    def fill(path, p):
        name = str(path[-1].key)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 2.0, p.shape), jnp.float32)
        scale = 0.1 if name.endswith("w_hh") else 0.3
        return jnp.asarray(rng.standard_normal(p.shape) * scale, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, variables)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_narrow_random_model_matches_flax(num_layers):
    rng = np.random.default_rng(num_layers)
    B, F, T = 2, 257, 24
    x = rng.standard_normal((B, F, T)).astype(np.float32)
    jmodel = JaxCNN(
        num_lstm_layers=num_layers, lstm_hidden_dim=16, freq_bins=F,
        enc_filters=(4, 8), dec_filters=(4, 8),
    )
    variables = _random_variables(jmodel, x, rng)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))

    model = cnn_blstm_from_numpy(flatten(variables), device="cpu")
    assert model.lstm.num_layers == num_layers and model.dec_filters == (4, 8)
    with torch.no_grad():
        got = model(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (B, F, T)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_f16_flat_weights_are_widened():
    """An f16 export (the committed format) loads as f32 with the f16 values."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 33, 6)).astype(np.float32)
    jmodel = JaxCNN(num_lstm_layers=1, lstm_hidden_dim=8, freq_bins=33,
                    enc_filters=(2, 4), dec_filters=(2, 4))
    flat = {k: v.astype(np.float16) for k, v in flatten(_random_variables(jmodel, x, rng)).items()}
    sd = cnn_blstm_state_dict(flat)
    assert all(v.dtype in (torch.float32, torch.int64) for v in sd.values())
    np.testing.assert_array_equal(
        sd["enc_conv1.weight"].numpy(),
        flat["params/enc_conv1/kernel"].astype(np.float32).transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(
        sd["projection.weight"].numpy(), flat["params/projection/kernel"].astype(np.float32).T
    )
    np.testing.assert_array_equal(
        sd["enc_bn0.running_var"].numpy(), flat["batch_stats/enc_bn0/var"].astype(np.float32)
    )


def test_unexpected_weight_key_raises():
    with pytest.raises(ValueError, match="unexpected"):
        cnn_blstm_state_dict({"params/head/kernel": np.zeros((2, 2), np.float32)})


@pytest.mark.parametrize("kw", [dict(in_channels=2), dict(global_pool=True)])
def test_later_slice_variants_raise(kw):
    """Once refused, both variants are ported now: they build, with the
    BiLSTM input their layout gives (channels x bins, or channels alone),
    and map ``(B, F, T, C)`` (phase mode) or ``(B, F, T)`` through.  Their
    numbers against JAX: ``tests/test_torch_phase_cnn.py``."""
    model = StackedBLSTMCNN(num_lstm_layers=1, lstm_hidden_dim=8, freq_bins=9,
                            enc_filters=(2, 3), dec_filters=(2, 3), **kw)
    phase = kw.get("in_channels") == 2
    assert model.lstm.l0_fwd_w_ih.shape[0] == (4 * 9 * 2 // 2 if phase else 4)
    shape = (2, 9, 5, 2) if phase else (2, 9, 5)
    with torch.no_grad():
        assert model.eval()(torch.zeros(shape)).shape == shape


@pytest.mark.parametrize("name", ["cnn_blstm_formant_v2_r2.npz", "cnn_blstm_formant_r2.npz"])
def test_committed_checkpoint_full_width_matches_flax(speech_like, name):
    """A committed checkpoint at full width (16448 -> 3x2x128 BiLSTM ->
    4112) on the log10 spectrogram of a 1 s clip."""
    ckpt = os.path.join(os.path.dirname(CKPT), name)
    clip = speech_like[:16000]
    spec = jax_stft(jnp.asarray(clip), n_fft=512, hop_length=192, win_length=384)
    x = np.asarray(jnp.log10(jnp.abs(spec) + 1e-9))[None]  # (1, 257, 84)
    want = np.asarray(JaxCNN(freq_bins=257).apply(jax_load_npz(ckpt), jnp.asarray(x), train=False))

    flat = load_params_npz(ckpt)
    from_flat = cnn_blstm_from_numpy(flat, device="cpu")
    from_cfg = build_model(Config(), device="cpu")
    from_cfg.load_state_dict(cnn_blstm_state_dict(flat))
    with torch.no_grad():
        got = from_flat(torch.tensor(x)).numpy()
        got_cfg = from_cfg(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (1, 257, 84)
    np.testing.assert_array_equal(got_cfg, got)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)

"""The VGG19 perceptual and style losses of the port (``models/vgg.py``,
``weights.vgg19_*``) against the JAX package's (``models/vgg.py``) on the
CPU, from the same weights (JAX's seed-42 init carried across).

Tolerances:

* ``preprocess_for_vgg`` at the full 257 x 626 spectrogram: 3e-4 absolute
  on outputs up to ~2.6 in magnitude.  The antialiased bilinear resize to
  256 x 624 is ``F.interpolate(antialias=True)`` here and
  ``jax.image.resize`` there, the same triangle filter widened by the scale
  with its weights computed in another way: measured 5.4e-5 (generated) and
  3.6e-5 (target) on these inputs; without the antialiasing, 3.1e-2;
* features at every captured layer: 2e-4 of the layer's largest magnitude
  (the resize residual, carried through up to 14 convolutions of <= 4608
  terms; measured 1.4e-6 to 1.4e-5);
* perceptual and style losses: 1e-5 relative (means of the features'
  differences, where the residual averages out; measured 1.9e-7 and 1.1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.models import vgg as jax_vgg
from ml_audio_inpainting_torch.models.vgg import (
    CAPTURE_LAYERS,
    PERCEPTUAL_LAYERS,
    STYLE_LAYERS,
    VGG19Features,
    load_torch_vgg19,
    preprocess_for_vgg,
    vgg19_params,
    vgg_perceptual_style_losses,
)
from ml_audio_inpainting_torch.weights import vgg19_flat_variables, vgg19_state_dict
from torch_threads import one_thread  # noqa: F401  (a module fixture)

FULL = (1, 257, 626)  # (B, F, T) of a 5 s clip on the GAN's STFT profile


def _jax_params(capture=CAPTURE_LAYERS):
    """``vgg19_params``' params (the same module and key; the init's input
    size does not change the draws)."""
    model = jax_vgg.VGG19Features(capture_layers=tuple(capture))
    return model, model.init(jax.random.PRNGKey(42), jnp.zeros((1, 16, 16, 3)))


def _flat(params):
    return {f"params/{name}/{leaf}": np.asarray(v) for name, d in params["params"].items()
            for leaf, v in d.items()}


def _port(variables, capture=CAPTURE_LAYERS):
    model = VGG19Features(capture)
    model.load_state_dict(vgg19_state_dict(_flat(variables)))
    return model


def _spectrograms(seed=0):
    rng = np.random.default_rng(seed)
    generated = np.tanh(rng.standard_normal(FULL)).astype(np.float32)
    target = np.log1p(np.abs(rng.standard_normal(FULL) * 3.0)).astype(np.float32)
    return generated, target


@pytest.mark.parametrize("is_generated", [True, False])
def test_preprocess_matches_jax_at_full_size(is_generated):
    generated, target = _spectrograms()
    x = np.concatenate([generated, generated * 0.5]) if is_generated else np.concatenate(
        [target, target * 0.25])  # B=2: the target's normaliser is the batch's max
    want = np.asarray(jax_vgg.preprocess_for_vgg(jnp.asarray(x), is_generated))
    got = preprocess_for_vgg(torch.tensor(x), is_generated).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-4)


def test_preprocess_follows_the_input_dtype():
    x = torch.ones(1, 64, 64, dtype=torch.bfloat16)
    assert preprocess_for_vgg(x, is_generated=True).dtype == torch.bfloat16
    assert preprocess_for_vgg(x.float(), is_generated=False).dtype == torch.float32


def test_features_and_losses_match_jax():
    """B=1 at the full size: every captured layer's features, then the
    perceptual and style losses (the port's one VGG forward test)."""
    model_j, variables = _jax_params()
    model = _port(variables)
    generated, target = _spectrograms(1)
    x_j = jax_vgg.preprocess_for_vgg(jnp.asarray(generated), True)
    feats_j = model_j.apply(variables, x_j)
    with torch.no_grad():
        feats = model(preprocess_for_vgg(torch.tensor(generated), True))
        p, s = vgg_perceptual_style_losses(model, torch.tensor(generated), torch.tensor(target))
    assert sorted(feats) == sorted(feats_j) == list(CAPTURE_LAYERS)
    for layer in CAPTURE_LAYERS:
        want = np.asarray(feats_j[layer])
        got = feats[layer].permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max(),
                                   err_msg=f"layer {layer}")
    p_j, s_j = jax_vgg.vgg_perceptual_style_losses(
        model_j, variables, jnp.asarray(generated), jnp.asarray(target))
    np.testing.assert_allclose(float(p), float(p_j), rtol=1e-5)
    np.testing.assert_allclose(float(s), float(s_j), rtol=1e-5)
    assert float(p) > 0 and float(s) > 0


def test_gram_matches_jax():
    feats = np.random.default_rng(3).standard_normal((2, 5, 7, 6)).astype(np.float32)  # NHWC
    from ml_audio_inpainting_torch.models.vgg import _gram

    want = np.asarray(jax_vgg._gram(jnp.asarray(feats)))
    got = _gram(torch.tensor(feats).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_load_torch_vgg19_reads_a_torchvision_state_dict(tmp_path):
    """A synthetic torchvision-layout file (every ``features.N`` of VGG19 and
    a classifier) loads into the layers the model has, unchanged."""
    rng = np.random.default_rng(5)
    sd = {}
    for idx, (c_in, c_out) in jax_vgg.VGG19_CONV_LAYERS.items():
        sd[f"features.{idx}.weight"] = torch.tensor(
            rng.standard_normal((c_out, c_in, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.tensor(rng.standard_normal(c_out).astype(np.float32))
    sd["classifier.0.weight"] = torch.zeros(4, 3)
    path = tmp_path / "vgg19.pth"
    torch.save(sd, path)
    model = load_torch_vgg19(str(path), VGG19Features((0, 2)))
    for name, value in model.state_dict().items():
        assert torch.equal(value, sd[name]), name
    assert len(model.state_dict()) == 4  # features.0 and features.2, weight and bias
    # and through vgg19_params, as MAI_VGG19_WEIGHTS names it
    loaded = vgg19_params((0, 2), weights_path=str(path), device="cpu")
    assert torch.equal(loaded.features[2].weight, sd["features.2.weight"])
    del sd["features.2.bias"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="features.2.bias"):
        load_torch_vgg19(str(path), VGG19Features((0, 2)))


def test_frozen_and_round_trip():
    model = vgg19_params(device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    model.train()
    assert not model.training
    flat = vgg19_flat_variables(model.state_dict())
    back = vgg19_state_dict(flat)
    for name, value in model.state_dict().items():
        assert torch.equal(back[name], value), name


def test_init_moments_match_jax():
    """The port's seed-42 draw against JAX's: each kernel's std within 4.5
    standard errors (std / sqrt(2 n) each), biases zero."""
    _, variables = _jax_params()
    want = _flat(variables)
    got = vgg19_flat_variables(vgg19_params(device="cpu").state_dict())
    assert set(got) == set(want)
    for key, value in want.items():
        if key.endswith("kernel"):
            se = np.sqrt(1.0 / (2 * value.size) + 1.0 / (2 * got[key].size))
            assert abs(got[key].std() / value.std() - 1.0) < 4.5 * se, key
            fan_in = np.prod(value.shape[:3])
            assert abs(got[key].std() * np.sqrt(fan_in) - 1.0) < 4.5 * np.sqrt(
                1 / (2 * value.size)), key
        else:
            assert not got[key].any() and not value.any(), key


def test_layer_lists():
    assert PERCEPTUAL_LAYERS == jax_vgg.PERCEPTUAL_LAYERS
    assert STYLE_LAYERS == jax_vgg.STYLE_LAYERS

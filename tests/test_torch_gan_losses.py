"""The GAN losses of the port (``train/losses.py``) against the JAX
package's (``train/losses.py:66-119``) on the CPU, on seeded inputs.

Tolerance: rtol 1e-6 for every term (f32 sums and means of <= 10^4 terms
in another order; the L1 terms are sums divided by the mask counts plus
1e-8, as in JAX), and exact zeros where generated equals original.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.train import losses as jax_losses
from ml_audio_inpainting_torch.train.losses import (
    bce_with_logits,
    discriminator_loss,
    generator_losses,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture)

LAMBDAS = {"lambda_adv": 0.01, "lambda_l1_valid": 1.0, "lambda_l1_hole": 2.0,
           "lambda_mag_weighted": 0.2, "lambda_vgg_perceptual": 4.0, "lambda_vgg_style": 500.0}
SHAPE = (2, 33, 40)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    gen = np.tanh(rng.standard_normal(SHAPE)).astype(np.float32)
    orig = np.log1p(np.abs(rng.standard_normal(SHAPE))).astype(np.float32)
    mask = np.ones(SHAPE, np.float32)
    mask[:, :, 10:17] = 0.0
    logits = (3.0 * rng.standard_normal((2, 5, 6, 1))).astype(np.float32)
    vgg = (np.float32(rng.uniform(0.1, 1)), np.float32(rng.uniform(1e-4, 1e-3)))
    return gen, orig, mask, logits, vgg


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("with_vgg", [False, True])
def test_generator_losses_match_jax(with_vgg):
    gen, orig, mask, logits, vgg = _inputs(0)
    want = jax_losses.generator_losses(jnp.asarray(gen), jnp.asarray(orig), jnp.asarray(mask),
                                       jnp.asarray(logits), LAMBDAS,
                                       tuple(map(jnp.asarray, vgg)) if with_vgg else None)
    got = generator_losses(_t(gen), _t(orig), _t(mask), _t(logits), LAMBDAS,
                           tuple(map(_t, vgg)) if with_vgg else None)
    assert set(got) == set(want) and len(got) == 7
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), float(value), rtol=1e-6, err_msg=key)


def test_discriminator_loss_matches_jax():
    _, _, _, real, _ = _inputs(1)
    _, _, _, fake, _ = _inputs(2)
    want = jax_losses.discriminator_loss(jnp.asarray(real), jnp.asarray(fake))
    got = discriminator_loss(_t(real), _t(fake))
    assert set(got) == set(want) == {"d_total", "d_real", "d_fake"}
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), float(value), rtol=1e-6, err_msg=key)


def test_bce_with_logits_large_logits_matches_jax():
    z = np.array([-80.0, -20.0, -1e-3, 0.0, 1e-3, 20.0, 80.0], np.float32)
    for target in (0.0, 1.0):
        want = float(jax_losses.bce_with_logits(jnp.asarray(z), jnp.full_like(z, target)))
        got = float(bce_with_logits(_t(z), torch.full((7,), target)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_zero_for_identical():
    """Generated equal to original: every L1 term and the weighted term are
    exactly 0, as in ``tests/test_gan.py::test_losses_zero_for_identical``'s
    spirit; only the adversarial term remains."""
    _, orig, mask, logits, _ = _inputs(3)
    got = generator_losses(_t(orig), _t(orig), _t(mask), _t(logits), LAMBDAS)
    for key in ("g_l1_valid", "g_l1_hole", "g_mag_weighted", "g_vgg_perceptual", "g_vgg_style"):
        assert float(got[key]) == 0.0, key
    np.testing.assert_allclose(float(got["g_total"]), 0.01 * float(got["g_adv"]), rtol=1e-6)

"""The spectral-norm PatchGAN of the port (``models/discriminator.py``,
``weights.discriminator_*``) against the JAX package's flax model with
``nn.SpectralNorm`` on the CPU, from the same weights.

Tolerances (f32, the same convolutions summed in another order):

* logits: 1e-5 of their largest magnitude (five convolutions of <= 4096
  terms each, divided by a sigma that agrees to ~1e-7 relative);
* the stored ``u`` and ``sigma`` after a real then a fake pass: 1e-6 (unit
  vectors and values near 1, from two products of the kernel matrix);
* gradients of ``sum(w * logits)`` with respect to every parameter: within
  1e-5 of the tensor's largest entry (sigma's gradient flows through the
  kernel in both, ``u`` and ``v`` carry none);
* init: each kernel's std within 4.5 standard errors of JAX's at the same
  shape (the draws differ; the std of a sample of n has a standard error of
  about std / sqrt(2 n)), u's mean and std those of N(0, 1), and one power
  step from the stored state giving sigma 1 within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.models.discriminator import Discriminator as JaxDiscriminator
from ml_audio_inpainting_torch.models.discriminator import Discriminator, spectral_normalize
from ml_audio_inpainting_torch.weights import (
    discriminator_flat_variables,
    discriminator_state_dict,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture)

LAYERS = ((8, 2), (16, 2))
SHAPE = (2, 40, 52)  # (B, F, T)


def flatten(tree, prefix=""):
    """``/``-joined flat keys of a nested flax tree (the npz's form)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flatten(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def unflatten(flat):
    """The flax tree of flat D variables: a spectral-norm key is
    ``batch_stats/SpectralNorm_{i}/{name}/kernel/u``, whose last three
    parts are one dict key."""
    tree = {}
    for key, value in flat.items():
        parts = key.split("/")
        if parts[0] == "batch_stats":
            parts = parts[:2] + ["/".join(parts[2:])]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(value)
    return tree


def _jax_variables(layers=LAYERS, seed=0):
    d = JaxDiscriminator(layer_cfg=layers)
    return d, d.init(jax.random.PRNGKey(seed), jnp.zeros(SHAPE), train=False)


def _port(flat, layers=LAYERS):
    disc = Discriminator(layer_cfg=layers)
    disc.load_state_dict(discriminator_state_dict(flat))
    return disc


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(SHAPE).astype(np.float32), rng.standard_normal(SHAPE).astype(
        np.float32)


def _logits_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(train):
    d, variables = _jax_variables()
    x, _ = _inputs()
    want = d.apply(variables, jnp.asarray(x), train=train, mutable=["batch_stats"])[0]
    disc = _port(flatten(variables))
    got = _logits_nhwc(disc(torch.tensor(x), update_stats=train))
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_spectral_norm_state_after_real_then_fake():
    d, variables = _jax_variables()
    real, fake = _inputs()
    _, upd = d.apply(variables, jnp.asarray(real), train=True, mutable=["batch_stats"])
    _, upd = d.apply({"params": variables["params"], **upd}, jnp.asarray(fake), train=True,
                     mutable=["batch_stats"])
    want = flatten({"batch_stats": upd["batch_stats"]})

    disc = _port(flatten(variables))
    disc(torch.tensor(real), update_stats=True)
    disc(torch.tensor(fake), update_stats=True)
    got = discriminator_flat_variables(disc.state_dict())
    moved = 0
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-6, err_msg=key)
        moved += not np.array_equal(value, flatten(variables)[key])
    assert moved == len(want)  # every u and sigma was updated

    # update_stats=False runs the power step but stores nothing.
    before = {k: v.clone() for k, v in disc.state_dict().items()}
    disc(torch.tensor(real), update_stats=False)
    for k, v in disc.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_gradients_match_jax():
    d, variables = _jax_variables()
    x, _ = _inputs()
    w = np.random.default_rng(7).standard_normal(
        d.apply(variables, jnp.asarray(x))[..., 0].shape).astype(np.float32)

    def scalar(params):
        out, _ = d.apply({"params": params, "batch_stats": variables["batch_stats"]},
                         jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out[..., 0] * w)

    want = flatten({"params": jax.grad(scalar)(variables["params"])})
    disc = _port(flatten(variables))
    params = dict(disc.named_parameters())
    logits, _, _ = disc.apply_sn(params, disc.sn_state(), torch.tensor(x))
    grads = torch.autograd.grad((logits[:, 0] * torch.tensor(w)).sum(), list(params.values()))
    got = discriminator_flat_variables(dict(zip(params, grads)))
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-5 * np.abs(value).max(),
                                   err_msg=key)


def test_spectral_norm_bounds_lipschitz():
    """The port's counterpart of ``tests/test_gan.py::test_spectral_norm_bounds_lipschitz``:
    scaling the weights by 10 does not scale the output by 10."""
    disc = Discriminator(layer_cfg=((8, 2),), kernel_size=4)
    disc.init_weights(torch.Generator().manual_seed(1))
    x = torch.tensor(np.random.default_rng(0).standard_normal((1, 32, 32)).astype(np.float32))
    with torch.no_grad():
        y1 = disc(x)
    with torch.no_grad():
        for p in disc.parameters():
            p.mul_(10.0)
        y2 = disc(x)
    assert float(y2.abs().mean() / (y1.abs().mean() + 1e-8)) < 5.0


def test_spectral_normalize_is_flax_rule_on_a_matrix():
    """One power step on a 1x1 kernel is flax's on the (I, O) matrix: sigma
    equals v W u'^T, and W / sigma has its largest singular value near 1
    after a few steps."""
    rng = np.random.default_rng(3)
    w = torch.tensor(rng.standard_normal((6, 5, 1, 1)).astype(np.float32))
    u = torch.tensor(rng.standard_normal((1, 6)).astype(np.float32))
    for _ in range(50):
        w_sn, u, sigma = spectral_normalize(w, u)
    top = torch.linalg.matrix_norm(w[..., 0, 0], ord=2)
    assert abs(float(sigma) - float(top)) < 1e-5 * float(top)
    assert abs(float(torch.linalg.matrix_norm(w_sn[..., 0, 0], ord=2)) - 1.0) < 1e-5


def test_flat_keys_round_trip_bit_for_bit():
    _, variables = _jax_variables(layers=((64, 2), (128, 2), (256, 2), (512, 1)))
    flat = flatten(variables)
    assert "batch_stats/SpectralNorm_4/final_conv/kernel/u" in flat
    back = discriminator_flat_variables(discriminator_state_dict(flat))
    assert set(back) == set(flat)
    for key, value in flat.items():
        assert back[key].dtype == value.dtype and np.array_equal(back[key], value), key


@pytest.mark.parametrize("use_spectral_norm", [False, True])
def test_init_moments_match_jax(use_spectral_norm):
    """Without spectral norm, the kernels are the lecun_normal draws: each
    layer's std agrees with JAX's.  With it, flax's init stores each kernel
    divided by the sigma of one power step from the stored u, so one more
    such step from the stored state gives sigma 1 in both packages."""
    layers = ((64, 2), (128, 2), (256, 2), (512, 1))
    d = JaxDiscriminator(layer_cfg=layers, use_spectral_norm=use_spectral_norm)
    want = flatten(d.init(jax.random.PRNGKey(4), jnp.zeros(SHAPE), train=False))
    disc = Discriminator(layer_cfg=layers, use_spectral_norm=use_spectral_norm)
    disc.init_weights(torch.Generator().manual_seed(4))
    got = discriminator_flat_variables(disc.state_dict())
    assert set(got) == set(want)
    for key, value in want.items():
        mine = got[key]
        if key.endswith("/kernel") and not use_spectral_norm:
            fan_in = np.prod(value.shape[:3])
            se = np.sqrt(1.0 / (2 * value.size) + 1.0 / (2 * mine.size))
            assert abs(mine.std() / value.std() - 1.0) < 4.5 * se, key
            assert abs(mine.std() * np.sqrt(fan_in) - 1.0) < 4.5 * np.sqrt(1 / (2 * mine.size)), key
        elif key.endswith("/kernel"):
            name = key.split("/")[1]
            u_key = next(k for k in want if k.endswith(f"/{name}/kernel/u"))
            for flat in (want, got):
                w = torch.tensor(flat[key]).permute(3, 2, 0, 1)  # HWIO -> OIHW
                sigma = spectral_normalize(w, torch.tensor(flat[u_key]))[2]
                assert abs(float(sigma) - 1.0) < 1e-5, key
        elif key.endswith("/bias"):
            assert not mine.any() and not value.any(), key
        elif key.endswith("/sigma"):
            assert mine == 1.0 and value == 1.0, key
    if use_spectral_norm:
        us = np.concatenate([got[k].ravel() for k in got if k.endswith("/u")])
        assert abs(us.mean()) < 4.5 / np.sqrt(us.size)
        assert abs(us.std() - 1) < 4.5 / np.sqrt(2 * us.size)

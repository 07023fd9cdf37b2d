"""Fresh generator weights in the port (``PConvUNet.init_weights``) drawn
from the JAX package's distributions: flax's default ``nn.Conv`` init
(``lecun_normal``: a normal truncated to 2 standard deviations with
variance 1 / fan_in), zero partial-convolution biases, and BatchNorm scale
1, bias 0, running mean 0, variance 1.

The draws differ (a ``torch.Generator`` cannot replay ``jax.random``), so
the kernels are held by their moments: each layer's std within 4.5
standard errors of JAX's ``PConvUNet.init`` at the same shape (the std of a
sample of n has a standard error of about std / sqrt(2 n)) and of the
analytic 1 / sqrt(fan_in).  The widths are chosen so every kernel has at
least 288 entries, where that test tells flax's init from torch's default
``kaiming_uniform_(a=sqrt(5))`` (std 1 / sqrt(3 fan_in), 0.58 of it): a
fresh module without ``init_weights`` fails it on every layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.models.pconv_unet import PConvUNet as JaxPConvUNet
from ml_audio_inpainting_torch.models.pconv_unet import PConvUNet
from ml_audio_inpainting_torch.weights import pconv_unet_flat_variables
from torch_threads import one_thread  # noqa: F401  (a module fixture)

ENC = ((32, 7, 2), (64, 5, 2), (64, 3, 2))
DEC = ((64, 3, 1), (32, 3, 1))
FINAL = 32


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def jax_init():
    net = JaxPConvUNet(enc_layer_cfg=ENC, dec_layer_cfg=DEC, final_interim_ch=FINAL)
    x = jnp.zeros((1, 32, 40))
    return _flatten(jax.jit(lambda k: net.init(k, x, jnp.ones_like(x), train=False))(
        jax.random.PRNGKey(0)))


def _kernel_failures(got, want):
    """Kernels whose std is off JAX's or the analytic one by more than 4.5
    standard errors."""
    bad = []
    for key, value in want.items():
        if not key.endswith("/kernel"):
            continue
        mine = got[key]
        se = np.sqrt(1.0 / (2 * value.size) + 1.0 / (2 * mine.size))
        fan_in = np.prod(value.shape[:3])
        if (abs(mine.std() / value.std() - 1.0) >= 4.5 * se
                or abs(mine.std() * np.sqrt(fan_in) - 1.0) >= 4.5 * np.sqrt(1 / (2 * mine.size))):
            bad.append(key)
    return bad


def test_init_weights_draws_flax_distributions(jax_init):
    net = PConvUNet(ENC, DEC, final_interim_ch=FINAL)
    with torch.no_grad():  # scramble everything init_weights must set
        for t in net.state_dict().values():
            if t.is_floating_point():
                t.uniform_(2.0, 3.0)
    net.init_weights(torch.Generator().manual_seed(1))
    got = pconv_unet_flat_variables(net.state_dict())
    assert set(got) == set(jax_init)
    assert min(v.size for k, v in jax_init.items() if k.endswith("/kernel")) >= 288
    assert _kernel_failures(got, jax_init) == []
    for key, value in jax_init.items():
        if key.endswith(("/bias", "/mean")):
            assert not got[key].any() and not value.any(), key
        elif key.endswith(("/scale", "/var")):
            assert (got[key] == 1).all() and (value == 1).all(), key


def test_torch_default_init_fails_the_moment_test(jax_init):
    """The control: a fresh module keeps torch's default init, a third of
    flax's variance, and every kernel fails."""
    torch.manual_seed(0)
    got = pconv_unet_flat_variables(PConvUNet(ENC, DEC, final_interim_ch=FINAL).state_dict())
    kernels = [k for k in jax_init if k.endswith("/kernel")]
    assert sorted(_kernel_failures(got, jax_init)) == sorted(kernels)


def test_init_weights_is_deterministic_in_the_generator():
    a, b = (PConvUNet(ENC, DEC, final_interim_ch=FINAL) for _ in range(2))
    a.init_weights(torch.Generator().manual_seed(5))
    b.init_weights(torch.Generator().manual_seed(5))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name

"""The port's PConv U-Net (``models/pconv_unet.py``, ``weights.py``) against
the JAX package's flax model on the CPU, from the same variables.

Tolerances, each from what differs between the two packages (f32 sums of
the same products in another order; no TF32 on the CPU):

* ``PartialConv``: ``atol=1e-5`` on outputs of size ~1-10 (sums of up to
  c_in * k * k = 441 products, times a ratio of up to 441 at partly masked
  windows); the updated mask exactly (sums of small integers).
* The tiny generator of ``tests/test_inference.py`` with random BatchNorm
  statistics: ``atol=1e-5`` on the Tanh output.
* The default-width generator with ``gan_formant_v2_r2.npz``: ``atol=2e-5``
  on the Tanh output (1.3e-6 seen), through 14 layers of sums of up to
  9216 products.
* ``resize_nearest`` against ``jax.image.resize`` exactly (a gather).
* ``ones_conv`` (a sum pool) against ``_ones_conv`` (a convolution) exactly,
  in f32 and in bf16: sums of small integers, rounded once.
"""

import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.models.pconv_unet import PartialConv as JaxPartialConv
from ml_audio_inpainting_tpu.models.pconv_unet import _ones_conv as jax_ones_conv
from ml_audio_inpainting_tpu.models.pconv_unet import PConvUNet as JaxPConvUNet
from ml_audio_inpainting_tpu.train.checkpoints import load_params_npz as jax_load_npz
from ml_audio_inpainting_tpu.train.gan_trainer import build_generator as jax_build_generator
from ml_audio_inpainting_tpu.utils.config import Config as JaxConfig
from ml_audio_inpainting_torch.models.build import build_generator
from ml_audio_inpainting_torch.models.pconv_unet import (
    PartialConv,
    PConvUNet,
    ones_conv,
    resize_nearest,
)
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.weights import (
    load_params_npz,
    pconv_unet_flat_variables,
    pconv_unet_state_dict,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "results", "checkpoints", "gan_formant_v2_r2.npz")
TINY_ENC = [(8, 7, 2), (16, 5, 2), (16, 3, 2)]
TINY_DEC = [(16, 3, 1), (8, 3, 1)]


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, Mapping) else {key: np.asarray(v)})
    return out


def _tiny_configs():
    jcfg, cfg = JaxConfig(), Config()
    for c in (jcfg, cfg):
        c.model.generator.enc_layer_cfg = TINY_ENC
        c.model.generator.dec_layer_cfg = TINY_DEC
        c.model.generator.final_interim_ch = 8
    return jcfg, cfg


def _randomized(variables, rng):
    """Every leaf redrawn: kernels ~ N(0, 0.2), BatchNorm scale and bias
    ~ N(0, 0.2), means ~ N(0, 0.2) and variances ~ U(0.5, 2), so BatchNorm
    is no identity and every parameter shows in the output."""
    return jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.asarray(
            rng.uniform(0.5, 2.0, p.shape) if str(path[-1].key) == "var"
            else rng.standard_normal(p.shape) * 0.2, jnp.float32),
        variables,
    )


def _inputs(rng, b, f, t, gap=(0.4, 0.55)):
    """log1p-like magnitudes and a 1 = valid mask with a band of hole frames
    and scattered hole bins."""
    x = np.log1p(np.abs(rng.standard_normal((b, f, t)) * 3)).astype(np.float32)
    mask = (rng.uniform(size=(b, f, t)) > 0.05).astype(np.float32)
    mask[:, :, int(gap[0] * t) : int(gap[1] * t)] = 0.0
    return x, mask


def test_partial_conv_is_exactly_the_bias_where_the_window_is_all_hole():
    """Where ``updated == 0`` the output is the bias alone and nothing flows
    back, whatever the convolution left there.  The JAX model's direct
    convolution of the all-zero window gives an exact 0 (times a ratio of
    ~1e8 x the window); here the premasked input holds 1e-6 under its hole,
    standing for the round-off of a convolution algorithm that mixes
    neighbouring windows (an FFT or Winograd one), which that ratio would
    make ~1e4."""
    rng = np.random.default_rng(5)
    mask = np.ones((2, 1, 17, 23), np.float32)
    mask[:, :, :, 5:14] = 0.0
    x = rng.standard_normal((2, 3, 17, 23)).astype(np.float32)
    x = np.where(mask > 0, x, 1e-6).astype(np.float32)
    mod = PartialConv(3, 4, 3, 1, use_bias=True, premasked=True)
    with torch.no_grad():
        mod.bias.copy_(torch.arange(4.0))
    out, new_mask = mod(torch.tensor(x), None, torch.tensor(3 * mask))
    dead = (new_mask == 0).expand_as(out)
    assert dead.any()
    bias = mod.bias.detach()[None, :, None, None].expand_as(out)
    torch.testing.assert_close(out[dead], bias[dead], rtol=0, atol=0)
    (grad,) = torch.autograd.grad(out[dead].sum(), mod.conv.weight)
    assert torch.count_nonzero(grad) == 0


@pytest.mark.parametrize("features,kernel,stride,c_in", [(6, 7, 2, 2), (5, 3, 1, 9), (4, 5, 2, 3)])
@pytest.mark.parametrize("mask_kind", ["full", "holes", "premasked"])
def test_partial_conv_matches_flax(features, kernel, stride, c_in, mask_kind):
    """A full mask is a plain conv (ratio 1 where the window lies inside the
    input) plus the bias; holes renormalise
    by ``c_in * k * k / (updated + 1e-8)``, with positions whose window is
    all hole left at the bias; premasked takes ``x`` as already masked and
    a channel sum of two groups."""
    rng = np.random.default_rng(features * 10 + kernel)
    x = rng.standard_normal((2, 17, 23, c_in)).astype(np.float32)  # NHWC
    mask = np.ones((2, 17, 23, 1), np.float32)
    if mask_kind != "full":
        mask = (rng.uniform(size=mask.shape) > 0.3).astype(np.float32)
        mask[:, :, 5:14] = 0.0  # windows wholly in the hole
    premasked = mask_kind == "premasked"
    if premasked:
        other = (rng.uniform(size=mask.shape) > 0.5).astype(np.float32)
        other[:, :, 5:14] = 0.0
        x = np.concatenate([x[..., :1] * mask, x[..., 1:] * other], axis=-1)
        channel_sum = mask + (c_in - 1) * other
    else:
        channel_sum = c_in * mask
    jmod = JaxPartialConv(features, kernel, stride, use_bias=True, premasked=premasked)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask),
                          jnp.asarray(channel_sum))
    variables = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.3, jnp.float32), variables)
    want_out, want_mask = jmod.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                                     jnp.asarray(channel_sum))

    mod = PartialConv(c_in, features, kernel, stride, use_bias=True, premasked=premasked)
    params = variables["params"]
    mod.load_state_dict({
        "conv.weight": torch.tensor(np.asarray(params["conv"]["kernel"]).transpose(3, 2, 0, 1)),
        "bias": torch.tensor(np.asarray(params["bias"])),
    })
    nchw = lambda a: torch.tensor(a.transpose(0, 3, 1, 2))  # noqa: E731
    with torch.no_grad():
        out, new_mask = mod(nchw(x), None if premasked else nchw(mask), nchw(channel_sum))
    np.testing.assert_array_equal(new_mask.numpy().transpose(0, 2, 3, 1), np.asarray(want_mask))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), np.asarray(want_out),
                               rtol=0, atol=1e-5)
    if mask_kind == "full":
        # away from the borders, where the zero padding reaches no window
        plain = torch.nn.functional.conv2d(nchw(x), mod.conv.weight, mod.bias, stride=stride,
                                           padding=kernel // 2)
        reach = torch.nn.functional.conv2d(torch.ones(1, 1, 17, 23), torch.ones(1, 1, kernel, kernel),
                                           stride=stride, padding=kernel // 2)
        inner = (reach == kernel * kernel).expand_as(out)
        assert inner.any()
        torch.testing.assert_close(out[inner], plain[inner], rtol=0, atol=1e-5)
    else:
        bias = mod.bias.detach()[None, :, None, None].expand_as(out)
        dead = (new_mask == 0).expand_as(out)
        assert dead.any()
        torch.testing.assert_close(out[dead], bias[dead], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,stride", [(7, 2), (5, 2), (3, 2), (3, 1)])
def test_ones_conv_matches_jax(dtype, kernel, stride):
    """Channel sums as the generator makes them: c * mask at the encoder,
    ``c_dec * dec_mask + c_skip * skip_mask`` at the decoder (up to 1024 a
    pixel, 9216 a window)."""
    rng = np.random.default_rng(kernel * 10 + stride)
    a, b = (rng.uniform(size=(2, 29, 35, 1)) > 0.3 for _ in range(2))
    mask_sum = (512.0 * a + 512.0 * b).astype(np.float32)
    mask_sum[:, :, 10:20] = 0.0
    want = np.asarray(jax_ones_conv(jnp.asarray(mask_sum, dtype), kernel, stride, kernel // 2)
                      .astype(jnp.float32))
    got = ones_conv(torch.tensor(mask_sum.transpose(0, 3, 1, 2)).to(getattr(torch, dtype)),
                    kernel, stride, kernel // 2)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy().transpose(0, 2, 3, 1), want)
    assert (want == 0).any() and want.max() > 4096


@pytest.mark.parametrize("shape", [(1, 257, 126), (2, 40, 63), (1, 9, 5)])
def test_tiny_generator_matches_jax(shape):
    """The tiny generator of ``tests/test_inference.py``, from ``gen.init``
    variables redrawn and carried across by ``pconv_unet_state_dict``; the
    inputs pad to a multiple of 8 (on the 9 x 5 input by numpy's repeated
    reflection)."""
    jcfg, cfg = _tiny_configs()
    rng = np.random.default_rng(sum(shape))
    x, mask = _inputs(rng, *shape)
    jgen = jax_build_generator(jcfg)
    variables = _randomized(jax.jit(lambda k, a, m: jgen.init(k, a, m, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask)), rng)
    want = np.asarray(jax.jit(lambda v, a, m: jgen.apply(v, a, m, train=False))(
        variables, jnp.asarray(x), jnp.asarray(mask)))

    gen = build_generator(cfg, device="cpu")
    gen.load_state_dict(pconv_unet_state_dict(_flatten(variables)))
    with torch.inference_mode():
        got = gen(torch.tensor(x), torch.tensor(mask))
    assert got.shape == shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seconds", [1.5, 0.5])
def test_default_width_generator_with_committed_checkpoint_matches_jax(seconds):
    """``gan_formant_v2_r2.npz`` (25.8 M values, 69 keys) at the default
    widths on one short clip's spectrogram: 1.5 s (257 x 188 -> 384 x 256),
    and 0.5 s, whose 63 frames pad by 65 with numpy's repeated reflection."""
    frames = 1 + int(16000 * seconds) // 128
    rng = np.random.default_rng(frames)
    x, mask = _inputs(rng, 1, 257, frames)
    jgen = JaxPConvUNet()
    want = np.asarray(jax.jit(lambda v, a, m: jgen.apply(v, a, m, train=False))(
        jax_load_npz(CKPT), jnp.asarray(x), jnp.asarray(mask)))
    gen = build_generator(Config(), device="cpu")
    gen.load_state_dict(pconv_unet_state_dict(load_params_npz(CKPT)))
    with torch.inference_mode():
        got = gen(torch.tensor(x), torch.tensor(mask))
    assert got.shape == (1, 257, frames) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_committed_checkpoint_loads_strictly_and_round_trips():
    flat = load_params_npz(CKPT)
    assert len(flat) == 69 and all(v.dtype == np.float32 for v in flat.values())
    gen = build_generator(Config(), device="cpu")
    sd = pconv_unet_state_dict(flat)
    result = gen.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert sum(p.numel() for p in gen.parameters()) == 25_813_057
    torch.testing.assert_close(gen.enc0.pconv.conv.weight,
                               torch.tensor(flat["params/enc0/pconv/conv/kernel"]).permute(3, 2, 0, 1))
    torch.testing.assert_close(gen.dec3.norm.running_var,
                               torch.tensor(flat["batch_stats/dec3/norm/var"]))
    back = pconv_unet_flat_variables(gen.state_dict())
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value)


def test_state_dict_round_trip_of_the_tiny_generator():
    """flax variables -> state dict -> flax variables is the identity, and
    the state dict has every key of the module (BatchNorm's step counters
    included) and no other."""
    jcfg, cfg = _tiny_configs()
    rng = np.random.default_rng(7)
    x, mask = _inputs(rng, 1, 33, 20)
    variables = _flatten(_randomized(jax_build_generator(jcfg).init(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask), train=False), rng))
    sd = pconv_unet_state_dict(variables)
    gen = build_generator(cfg, device="cpu")
    assert set(sd) == set(gen.state_dict())
    gen.load_state_dict(sd)
    back = pconv_unet_flat_variables(gen.state_dict())
    assert set(back) == set(variables)
    for key, value in variables.items():
        np.testing.assert_array_equal(back[key], value)


@pytest.mark.parametrize("key", ["params/enc0/pconv/kernel", "batch_stats/enc0/norm/scale",
                                 "params/enc0/norm/mean", "params/final_pconv1/conv/bias"])
def test_unknown_weight_keys_raise(key):
    with pytest.raises(ValueError, match="unexpected PConv U-Net weight key"):
        pconv_unet_state_dict({key: np.zeros(3, np.float32)})


def test_generator_config_matches_jax():
    from ml_audio_inpainting_tpu.utils.config import load_config as jax_load_config

    for port, ref in ((Config(), JaxConfig()),
                      (Config.from_yaml(os.path.join(REPO, "configs", "gan.yaml")),
                       jax_load_config(os.path.join(REPO, "configs", "gan.yaml")))):
        assert port.to_dict()["model"]["generator"] == ref.to_dict()["model"]["generator"]
        assert port.to_dict()["model"]["cnn_blstm"] == ref.to_dict()["model"]["cnn_blstm"]
        assert port.to_dict()["data"] == ref.to_dict()["data"]
    spec = Config.from_yaml(os.path.join(REPO, "configs", "gan.yaml")).data.spectrogram
    assert (spec.n_fft, spec.hop_length, spec.win_length) == (512, 128, 512)
    gen = jax_build_generator(JaxConfig())
    assert PConvUNet().total_downsampling == gen.total_downsampling == 128


@pytest.mark.parametrize("src,dst", [((4, 6), (4, 6)), ((4, 6), (8, 12)), ((5, 7), (9, 4)),
                                     ((8, 8), (3, 5)), ((1, 3), (2, 7))])
def test_resize_nearest_matches_jax(src, dst):
    x = np.random.default_rng(0).standard_normal((2, 3, *src)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                       (2, *dst, 3), method="nearest")).transpose(0, 3, 1, 2)
    got = resize_nearest(torch.tensor(x), *dst)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decoder_stages_must_fit_the_encoder():
    with pytest.raises(ValueError, match="decoder stages"):
        PConvUNet(enc_layer_cfg=[(8, 3, 2), (8, 3, 2)], dec_layer_cfg=[(8, 3, 1), (8, 3, 1)])


_ONE_COLUMN_CHECK = """
import torch
from ml_audio_inpainting_torch.models.pconv_unet import PartialConv
torch.manual_seed(0)
pc = PartialConv({c_in}, 512, 3, 2, use_bias=False).eval()
with torch.no_grad():
    pc.conv.weight.mul_(20.0)
x = torch.randn(1, {c_in}, 6, {w})
mask = torch.ones(1, 1, 6, {w})
mask[..., :2, :] = 0
with torch.inference_mode():
    want, want_m = pc(x, mask, {c_in} * mask)
    got, got_m = pc.to(torch.bfloat16)(x.bfloat16(), mask.bfloat16(), ({c_in} * mask).bfloat16())
assert torch.equal(got_m.float(), want_m), "mask"
err = (got.float() - want).abs().max().item()
print(err)
assert err <= 0.02 * want.abs().max().item() + 1e-3, err
"""


@pytest.mark.parametrize("c_in,w", [(512, 2), (512, 1), (128, 2), (512, 4)])
def test_bf16_one_column_convolution_on_the_cpu_writes_every_output(c_in, w):
    """Witness of a oneDNN fault on the CPU: its bf16 convolution leaves most
    outputs of a result one column wide unwritten (here with 128 input
    channels or more; the generator's last encoder stage gives one at clips
    of 1 s or shorter), so they hold whatever the memory held before, and
    the bf16 generator returned NaN now and then.  Under glibc's
    ``MALLOC_PERTURB_`` every allocation is filled with 0x7f bytes (3.4e38
    in bf16), which makes the fault show on every run: the port's partial
    conv in bf16 must stay within bf16's rounding (sums over up to 4608
    products) of its f32 result.  ``(512, 4)`` is a two-column result, the
    control."""
    import subprocess
    import sys

    env = dict(os.environ, MALLOC_PERTURB_="128", MALLOC_MMAP_THRESHOLD_="33554432",
               PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, "-c", _ONE_COLUMN_CHECK.format(c_in=c_in, w=w)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]

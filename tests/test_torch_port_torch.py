"""The reference's PyTorch checkpoints and earlier models in the port
(``models/port_torch.py``, ``models/legacy_blstm.py``) against the JAX
package on the CPU.

The reference's own ``.pt`` files are not in the repository, so the
checkpoints here are seeded synthetic ``state_dict``\\ s in the reference's
layout (``tests/test_port_torch.py``'s ``TorchModel`` names: ``encoder.0``
... ``decoder.6``, ``nn.LSTM``'s ``weight_ih_l{k}[_reverse]``; the PConv
U-Net's ``encoder_blocks``/``decoder_blocks``/``final_decoder_layer``, with
the mask convolutions and ``num_batches_tracked`` counters the loaders
skip), written with ``torch.save``.  Both packages load the same file.

Tolerances: the flat variables the two loaders make are equal bit for bit
(the same transposes, and the LSTM's two biases summed in f32 numpy in
both); model outputs within atol 5e-5 (CNN+BiLSTM, as the full-width
forward of ``tests/test_torch_cnn_blstm.py``) and 1e-5 (PConv U-Net, as the
tiny generator of ``tests/test_torch_pconv_unet.py``); the legacy models'
outputs within 5e-5 and their gradients per tensor within 1e-4 of the
tensor's largest entry (``tests/test_torch_cnn_train.py``'s bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.models import legacy_blstm as jax_legacy
from ml_audio_inpainting_tpu.models import port_torch as jax_port
from ml_audio_inpainting_torch.models import legacy_blstm
from ml_audio_inpainting_torch.models.pconv_unet import PConvUNet
from ml_audio_inpainting_torch.models.port_torch import (
    load_torch_cnn_blstm,
    load_torch_pconv_unet,
    seeded_reference_cnn_state_dict,
)
from test_torch_cnn_train import _assert_grads_close, flatten

FREQ = 257
ENC_CFG = ((8, 7, 2), (16, 5, 2), (16, 3, 2))
DEC_CFG = ((16, 3, 1), (8, 3, 1))


def reference_cnn_state_dict(seed: int, hidden: int = 16, layers: int = 2, enc=(4, 8),
                             dec=(4, 8), freq: int = FREQ, in_channels: int = 1,
                             global_pool: bool = False) -> dict:
    """A seeded reference CNN+BiLSTM ``state_dict`` of the narrow widths."""
    return seeded_reference_cnn_state_dict(seed, hidden, layers, enc, dec, freq, in_channels,
                                           global_pool)


def reference_pconv_state_dict(seed: int, enc_cfg=ENC_CFG, dec_cfg=DEC_CFG, interim: int = 8):
    """A seeded reference PConv U-Net ``state_dict``, shaped as the port's
    generator of the same widths (and with the all-ones mask convolutions
    the reference keeps)."""
    rng = np.random.default_rng(seed)
    port = PConvUNet(enc_cfg, dec_cfg, final_interim_ch=interim).state_dict()
    sd = {}
    for name, value in port.items():
        module, rest = name.split(".", 1)
        if module.startswith(("enc", "dec")):
            kind, i = ("encoder_blocks", module[3:]) if module.startswith("enc") else (
                "decoder_blocks", module[3:])
            out = f"{kind}.{i}.{rest}"
            if rest == "pconv.conv.weight":
                sd[f"{kind}.{i}.pconv.mask_conv.weight"] = torch.ones(value.shape)
        else:
            out = f"final_decoder_layer.{0 if module == 'final_pconv1' else 2}.{rest}"
        if value.dtype == torch.int64:
            sd[out] = torch.tensor(3)
        elif rest.endswith("running_var") or rest.endswith("norm.weight"):
            sd[out] = torch.tensor(rng.uniform(0.5, 1.5, value.shape), dtype=torch.float32)
        else:
            fan_in = value[0].numel() if value.dim() > 1 else 10
            sd[out] = torch.tensor(rng.standard_normal(value.shape) / np.sqrt(fan_in),
                                   dtype=torch.float32)
    return sd


@pytest.mark.parametrize("global_pool", [False, True], ids=["current", "global_pool"])
def test_load_torch_cnn_blstm_matches_jax(tmp_path, global_pool):
    path = tmp_path / "model.pt"
    torch.save(reference_cnn_state_dict(1, global_pool=global_pool), path)
    jmodel, jvars = jax_port.load_torch_cnn_blstm(str(path), use_pallas_lstm=False)
    model, flat = load_torch_cnn_blstm(path)
    want = flatten(jvars)
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    assert model.global_pool == jmodel.global_pool == global_pool
    assert model.lstm.num_layers == 2 and model.lstm.hidden_dim == 16 and not model.training
    x = np.random.default_rng(2).standard_normal((2, FREQ, 30)).astype(np.float32) - 3.0
    y_j = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(jvars, jnp.asarray(x)))
    with torch.no_grad():
        y = model(torch.tensor(x)).numpy()
    np.testing.assert_allclose(y, y_j, rtol=0, atol=5e-5)


def test_load_torch_cnn_blstm_refuses_inconsistent_shapes(tmp_path):
    sd = reference_cnn_state_dict(1)
    sd["encoder.6.weight"] = sd["encoder.6.weight"][:4]  # encoder output 4 != hidden / 2
    with pytest.raises(ValueError, match="hidden/2"):
        load_torch_cnn_blstm(sd)
    with pytest.raises(ValueError, match="freq_bins"):
        load_torch_cnn_blstm(reference_cnn_state_dict(1), freq_bins=129)


def test_load_torch_pconv_unet_matches_jax(tmp_path):
    path = tmp_path / "gen.pth"
    torch.save(reference_pconv_state_dict(3), path)
    sd = torch.load(path, weights_only=True)
    jmodel, jvars = jax_port.load_torch_pconv_unet(sd, ENC_CFG, DEC_CFG, final_interim_ch=8)
    model, flat = load_torch_pconv_unet(path, ENC_CFG, DEC_CFG, final_interim_ch=8)
    want = flatten(jvars)
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, FREQ, 40)).astype(np.float32)
    mask = np.ones_like(x)
    mask[..., 15:22] = 0.0
    y_j = np.asarray(jax.jit(lambda v, a, m: jmodel.apply(v, a, m, train=False))(
        jvars, jnp.asarray(x), jnp.asarray(mask)))
    with torch.no_grad():
        y = model(torch.tensor(x), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(y, y_j, rtol=0, atol=1e-5)


LEGACY = {
    "blstm": (dict(audio_feat_dim=33, hidden_dim=16, num_layers=2), (2, 21, 33)),
    "gap_only": (dict(audio_feat_dim=100, gap_fraction=0.04, hidden_dim=16, num_layers=1),
                 (1, 10, 100)),
    "norm": (dict(audio_feat_dim=20, hidden_dim=8, num_layers=2), (1, 7, 20)),
}
LEGACY_CLASSES = {"blstm": "StackedBLSTM", "gap_only": "StackedBLSTMGapOnly",
                  "norm": "StackedNormBLSTM"}


@pytest.mark.parametrize("name", sorted(LEGACY))
def test_legacy_models_match_jax(name):
    """Outputs and gradients (of a fixed linear function of the output) of
    each legacy model from the JAX model's variables, redrawn."""
    kw, shape = LEGACY[name]
    net = getattr(jax_legacy, LEGACY_CLASSES[name])(**kw)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    variables = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) / np.sqrt(p.shape[0]), jnp.float32),
        variables)
    model = legacy_blstm.load_flax_variables(getattr(legacy_blstm, LEGACY_CLASSES[name])(**kw),
                                             flatten(variables))
    out = model(torch.tensor(x))
    w = rng.standard_normal(out.shape).astype(np.float32)

    def loss(params):
        y = net.apply({"params": params}, jnp.asarray(x))
        return jnp.sum(y * w), y

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=5e-5)
    (out * torch.tensor(w)).sum().backward()
    got = {}
    for n, p in model.named_parameters():
        module, leaf = n.split(".")
        if module.startswith("blstm"):
            got[f"params/{module}/{leaf}"] = p.grad.numpy()
        elif module.startswith("norm"):
            got[f"params/{module}/{'scale' if leaf == 'weight' else leaf}"] = p.grad.numpy()
        else:
            got[f"params/{module}/{'kernel' if leaf == 'weight' else leaf}"] = (
                p.grad.numpy().T if leaf == "weight" else p.grad.numpy())
    _assert_grads_close(got, flatten({"params": grads}))


def test_legacy_compositing_and_init():
    """The composite keeps the input outside the gap (as JAX's
    ``test_legacy_compositing``), and the seeded init draws flax's
    distributions: dense biases and LayerNorm shifts zero, LayerNorm scales
    one, BiLSTM weights in [0, 2/sqrt(H))."""
    m = legacy_blstm.StackedNormBLSTM(audio_feat_dim=8, hidden_dim=4, num_layers=1)
    m.init_weights(torch.Generator().manual_seed(0))
    assert not m.fc.bias.any() and not m.norm0.bias.any() and (m.norm0.weight == 1).all()
    w = m.blstm0.l0_fwd_w_hh
    assert (w >= 0).all() and (w < 1.0).all() and w.std() > 0
    b = legacy_blstm.StackedBLSTM(audio_feat_dim=8, hidden_dim=4, num_layers=1)
    b.init_weights(torch.Generator().manual_seed(0))
    x = torch.full((1, 5, 8), 0.3)
    gm = torch.zeros((1, 5, 8))
    gm[:, 2] = 1.0
    out = b.reconstruct_spectrogram(x, gm)
    assert (out[:, [0, 1, 3, 4]] == 0.3).all() and b.training

"""Weights carried across from the JAX package.

The JAX package exports inference variables (``params`` + ``batch_stats``)
as a flat ``.npz`` with ``/``-joined flax paths as keys
(``ml_audio_inpainting_tpu/train/checkpoints.py::export_params_npz``); a
flax variables tree flattened with the same keys is the same thing in
memory.  This module turns such a flat dict into the port's modules:

* conv kernels go from flax HWIO ``(3, 3, in, out)`` to torch OIHW;
* dense kernels ``(in, out)`` become ``nn.Linear`` weights ``(out, in)``;
* ``batch_stats/*/mean|var`` become BatchNorm running stats;
* f16 values are widened to f32, as ``load_params_npz`` does there;
* BiLSTM parameters keep their names and ``(in, out)`` layouts.

:func:`cnn_blstm_flat_variables` goes the other way, so weights trained by
the port load in the JAX package (``train/checkpoints.py`` writes them).
:func:`pconv_unet_state_dict` and :func:`pconv_unet_flat_variables` do the
same for the GAN generator (its ``params/`` and ``batch_stats/``, from an
npz or from a flax train state flattened the same way),
:func:`discriminator_state_dict` and :func:`discriminator_flat_variables`
for the spectral-norm PatchGAN, and :func:`vgg19_state_dict` and
:func:`vgg19_flat_variables` for the VGG19 of the perceptual losses.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Union

import numpy as np
import torch

from ml_audio_inpainting_torch.models.cnn_blstm import StackedBLSTMCNN

__all__ = [
    "load_params_npz",
    "cnn_blstm_state_dict",
    "cnn_blstm_flat_variables",
    "cnn_blstm_from_numpy",
    "pconv_unet_state_dict",
    "pconv_unet_flat_variables",
    "discriminator_state_dict",
    "discriminator_flat_variables",
    "vgg19_state_dict",
    "vgg19_flat_variables",
]

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_BN_KEYS = {v: k for k, v in _BN_LEAVES.items()}


def _widen(arr) -> np.ndarray:
    arr = np.asarray(arr)
    return arr.astype(np.float32) if arr.dtype == np.float16 else arr


def load_params_npz(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """Flat ``{key: array}`` of an exported ``.npz``, f16 widened to f32."""
    with np.load(path) as data:
        return {key: _widen(data[key]) for key in data.files}


def cnn_blstm_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``state_dict`` of :class:`StackedBLSTMCNN` from flat flax variables."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        arr = _widen(value)
        collection, *path = key.split("/")
        if len(path) != 2 or collection not in ("params", "batch_stats"):
            raise ValueError(f"unexpected CNN+BiLSTM weight key {key!r}")
        module, leaf = path
        if module == "lstm":
            out = f"lstm.{leaf}"
        elif module == "projection":
            out, arr = f"projection.{'weight' if leaf == 'kernel' else leaf}", arr.T
        elif "_conv" in module:
            if leaf == "kernel":
                out, arr = f"{module}.weight", arr.transpose(3, 2, 0, 1)
            else:
                out = f"{module}.{leaf}"
        elif "_bn" in module and leaf in _BN_LEAVES:
            out = f"{module}.{_BN_LEAVES[leaf]}"
            sd[f"{module}.num_batches_tracked"] = torch.tensor(0)
        else:
            raise ValueError(f"unexpected CNN+BiLSTM weight key {key!r}")
        sd[out] = torch.tensor(arr)
    return sd


def cnn_blstm_flat_variables(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`cnn_blstm_state_dict`: flat flax variables (f32
    numpy) from a :class:`StackedBLSTMCNN` ``state_dict``, or from any subset
    of its entries (a dict of parameter gradients maps the same way).

    OIHW conv kernels go to HWIO, ``nn.Linear`` weights ``(out, in)`` to dense
    kernels ``(in, out)``, running statistics to ``batch_stats/*/mean|var``;
    ``num_batches_tracked`` has no flax counterpart and is dropped.
    """
    flat: Dict[str, np.ndarray] = {}
    for name, value in tensors.items():
        module, leaf = name.split(".", 1)
        if leaf == "num_batches_tracked":
            continue
        arr = value.detach().to("cpu", torch.float32).numpy()
        if module == "lstm":
            key = f"params/lstm/{leaf}"
        elif module == "projection":
            key, arr = f"params/projection/{'kernel' if leaf == 'weight' else leaf}", (
                arr.T if leaf == "weight" else arr)
        elif "_conv" in module:
            if leaf == "weight":
                key, arr = f"params/{module}/kernel", arr.transpose(2, 3, 1, 0)
            else:
                key = f"params/{module}/{leaf}"
        elif "_bn" in module and leaf in _BN_KEYS:
            collection = "batch_stats" if leaf.startswith("running_") else "params"
            key = f"{collection}/{module}/{_BN_KEYS[leaf]}"
        else:
            raise ValueError(f"unexpected CNN+BiLSTM tensor {name!r}")
        flat[key] = np.ascontiguousarray(arr)
    return flat


def cnn_blstm_from_numpy(flat: Mapping[str, np.ndarray], device="cuda") -> StackedBLSTMCNN:
    """:class:`StackedBLSTMCNN` on ``device`` in eval mode, with its widths
    read off the weights' shapes and the weights loaded (strictly: a missing
    or extra key raises).  The input channels come from the first conv (2:
    the phase-mode model), the frequency bins from the projection, and
    ``global_pool`` from the first BiLSTM layer's input width: the encoder's
    channels alone, not channels x bins (``port_torch.py:164``'s rule)."""
    p = "params/"
    n_enc = 0
    while f"{p}enc_conv{n_enc}/kernel" in flat:
        n_enc += 1
    enc_out = [np.shape(flat[f"{p}enc_conv{i}/kernel"])[3] for i in range(n_enc)]
    num_layers = 0
    while f"{p}lstm/l{num_layers}_fwd_w_hh" in flat:
        num_layers += 1
    hidden = np.shape(flat[f"{p}lstm/l0_fwd_w_hh"])[0]
    dec_filters = (np.shape(flat[f"{p}dec_conv1/kernel"])[3],
                   np.shape(flat[f"{p}dec_conv0/kernel"])[3])
    freq_bins = np.shape(flat[f"{p}projection/kernel"])[1] // dec_filters[0]
    model = StackedBLSTMCNN(
        in_channels=np.shape(flat[f"{p}enc_conv0/kernel"])[2],
        num_lstm_layers=num_layers,
        lstm_hidden_dim=hidden,
        freq_bins=freq_bins,
        enc_filters=tuple(enc_out[:-1]),
        dec_filters=dec_filters,
        global_pool=np.shape(flat[f"{p}lstm/l0_fwd_w_ih"])[0] != freq_bins * enc_out[-1],
    )
    model.load_state_dict(cnn_blstm_state_dict(flat))
    return model.to(device).eval()


def pconv_unet_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``state_dict`` of :class:`~ml_audio_inpainting_torch.models.pconv_unet.PConvUNet`
    from flat flax variables: ``params/{enc,dec}{i}/pconv/conv/kernel``
    (HWIO -> OIHW), ``params/{enc,dec}{i}/norm/{scale,bias}`` and
    ``batch_stats/{enc,dec}{i}/norm/{mean,var}`` (BatchNorm), and
    ``params/final_pconv{1,2}/{conv/kernel,bias}``."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        arr = _widen(value)
        collection, module, *path = key.split("/")
        if collection == "params" and path in (["pconv", "conv", "kernel"], ["conv", "kernel"]):
            out, arr = ".".join([module, *path[:-1], "weight"]), arr.transpose(3, 2, 0, 1)
        elif collection == "params" and module.startswith("final_pconv") and path == ["bias"]:
            out = f"{module}.bias"
        elif (len(path) == 2 and path[0] == "norm" and path[1] in _BN_LEAVES
              and collection == ("batch_stats" if path[1] in ("mean", "var") else "params")):
            out = f"{module}.norm.{_BN_LEAVES[path[1]]}"
            sd[f"{module}.norm.num_batches_tracked"] = torch.tensor(0)
        else:
            raise ValueError(f"unexpected PConv U-Net weight key {key!r}")
        sd[out] = torch.tensor(arr)
    return sd


def pconv_unet_flat_variables(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`pconv_unet_state_dict`: flat flax variables (f32
    numpy) from a ``PConvUNet`` ``state_dict``; ``num_batches_tracked`` has
    no flax counterpart and is dropped."""
    flat: Dict[str, np.ndarray] = {}
    for name, value in tensors.items():
        module, *path = name.split(".")
        if path[-1] == "num_batches_tracked":
            continue
        arr = value.detach().to("cpu", torch.float32).numpy()
        if path[-1] == "weight" and path[-2] == "conv":
            key, arr = "/".join(["params", module, *path[:-1], "kernel"]), arr.transpose(2, 3, 1, 0)
        elif path == ["bias"]:
            key = f"params/{module}/bias"
        elif len(path) == 2 and path[0] == "norm" and path[1] in _BN_KEYS:
            collection = "batch_stats" if path[1].startswith("running_") else "params"
            key = f"{collection}/{module}/norm/{_BN_KEYS[path[1]]}"
        else:
            raise ValueError(f"unexpected PConv U-Net tensor {name!r}")
        flat[key] = np.ascontiguousarray(arr)
    return flat


def _hwio_to_oihw(arr: np.ndarray) -> np.ndarray:
    return arr.transpose(3, 2, 0, 1)


def _oihw_to_hwio(tensor: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(tensor.detach().to("cpu", torch.float32).numpy().transpose(2, 3, 1, 0))


def discriminator_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``state_dict`` of :class:`~ml_audio_inpainting_torch.models.discriminator.Discriminator`
    from flat flax variables: ``params/{name}/kernel`` (HWIO -> OIHW) and
    ``params/{name}/bias``, and the spectral norm's
    ``batch_stats/SpectralNorm_{i}/{name}/kernel/u`` and ``.../sigma`` (flax
    names that collection ``{name}/kernel/u``, with its own slashes) as
    ``{name}.u`` and ``{name}.sigma``."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        arr = _widen(value)
        parts = key.split("/")
        if parts[0] == "params" and len(parts) == 3 and parts[2] in ("kernel", "bias"):
            name, leaf = parts[1], parts[2]
            out = f"{name}.{'weight' if leaf == 'kernel' else 'bias'}"
            if leaf == "kernel":
                arr = _hwio_to_oihw(arr)
        elif (parts[0] == "batch_stats" and len(parts) == 5 and parts[1].startswith("SpectralNorm_")
              and parts[3] == "kernel" and parts[4] in ("u", "sigma")):
            out = f"{parts[2]}.{parts[4]}"
        else:
            raise ValueError(f"unexpected discriminator weight key {key!r}")
        sd[out] = torch.tensor(arr)
    return sd


def discriminator_flat_variables(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`discriminator_state_dict`: flat flax variables (f32
    numpy) from a ``Discriminator`` ``state_dict`` or any subset of it;
    ``final_conv``'s spectral norm is ``SpectralNorm_{n}`` after the ``n``
    blocks'."""
    n_blocks = len({name.split(".")[0] for name in tensors if name.startswith("block")})
    flat: Dict[str, np.ndarray] = {}
    for name, value in tensors.items():
        module, leaf = name.split(".")
        if leaf == "weight":
            flat[f"params/{module}/kernel"] = _oihw_to_hwio(value)
            continue
        arr = value.detach().to("cpu", torch.float32).numpy().copy()  # keeps sigma 0-d
        if leaf == "bias":
            flat[f"params/{module}/bias"] = arr
        elif leaf in ("u", "sigma"):
            index = n_blocks if module == "final_conv" else int(module[len("block"):-len("_conv")])
            flat[f"batch_stats/SpectralNorm_{index}/{module}/kernel/{leaf}"] = arr
        else:
            raise ValueError(f"unexpected discriminator tensor {name!r}")
    return flat


def vgg19_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``state_dict`` of :class:`~ml_audio_inpainting_torch.models.vgg.VGG19Features`
    (torchvision's ``features.N.weight`` and ``.bias``) from the JAX
    package's VGG params, flat: ``params/conv{N}/kernel`` (HWIO -> OIHW) and
    ``params/conv{N}/bias``."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        parts = key.split("/")
        if not (len(parts) == 3 and parts[0] == "params" and parts[1].startswith("conv")
                and parts[2] in ("kernel", "bias")):
            raise ValueError(f"unexpected VGG19 weight key {key!r}")
        arr = _widen(value)
        index = int(parts[1][len("conv"):])
        if parts[2] == "kernel":
            sd[f"features.{index}.weight"] = torch.tensor(_hwio_to_oihw(arr))
        else:
            sd[f"features.{index}.bias"] = torch.tensor(arr)
    return sd


def vgg19_flat_variables(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`vgg19_state_dict`."""
    flat: Dict[str, np.ndarray] = {}
    for name, value in tensors.items():
        _, index, leaf = name.split(".")
        if leaf == "weight":
            flat[f"params/conv{index}/kernel"] = _oihw_to_hwio(value)
        else:
            flat[f"params/conv{index}/bias"] = np.ascontiguousarray(
                value.detach().to("cpu", torch.float32).numpy())
    return flat

"""The reference's PyTorch checkpoints loaded into the port's models (port
of ``ml_audio_inpainting_tpu/models/port_torch.py``).

The reference ships trained torch ``state_dict`` files (its CNN+BiLSTM as
``encoder``/``lstm``/``projection``/``decoder`` ``nn.Sequential`` modules,
its PConv U-Net as ``encoder_blocks``/``decoder_blocks``/
``final_decoder_layer``).  Each loader maps those names onto the JAX
package's flat flax variables, layer for layer as the JAX loader does, and
loads them strictly into the port's module through ``weights.py``:

* Conv2d ``(O, I, kh, kw)`` -> flax ``(kh, kw, I, O)``;
* BatchNorm weight and bias -> ``scale`` and ``bias``, running mean and
  variance -> ``batch_stats`` ``mean`` and ``var``;
* LSTM ``weight_ih_l{k}[_reverse]`` ``(4H, in)`` -> ``w_ih (in, 4H)``,
  ``weight_hh`` -> ``w_hh (H, 4H)``, the two biases summed into ``b``
  (gate order i, f, g, o in both);
* Linear ``(out, in)`` -> dense ``kernel (in, out)``.

The PConv U-Net's all-ones mask convolutions are constants of the
architecture and are skipped, as are ``num_batches_tracked`` counters.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from ml_audio_inpainting_torch.models.cnn_blstm import StackedBLSTMCNN
from ml_audio_inpainting_torch.models.pconv_unet import DEC_LAYER_CFG, ENC_LAYER_CFG, PConvUNet
from ml_audio_inpainting_torch.weights import cnn_blstm_from_numpy, pconv_unet_state_dict

__all__ = ["load_torch_cnn_blstm", "load_torch_pconv_unet", "reference_state_dict",
           "seeded_reference_cnn_state_dict"]

StateDictSource = Union[str, Path, Mapping[str, torch.Tensor], torch.nn.Module]


def reference_state_dict(source: StateDictSource) -> Dict[str, np.ndarray]:
    """``{name: f32 numpy array}`` of a reference ``state_dict``: a ``.pt``
    or ``.pth`` file (``torch.load(..., map_location="cpu",
    weights_only=True)``), a mapping of tensors, or a module."""
    if isinstance(source, (str, Path)):
        source = torch.load(source, map_location="cpu", weights_only=True)
    if hasattr(source, "state_dict"):
        source = source.state_dict()
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in source.items()}


def _hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _conv(sd, name: str, into: str, flat: dict) -> None:
    flat[f"params/{into}/kernel"] = _hwio(sd[f"{name}.weight"])
    flat[f"params/{into}/bias"] = sd[f"{name}.bias"]


def _bn(sd, name: str, into: str, flat: dict, prefix: str = "") -> None:
    flat[f"params/{into}/{prefix}scale"] = sd[f"{name}.weight"]
    flat[f"params/{into}/{prefix}bias"] = sd[f"{name}.bias"]
    flat[f"batch_stats/{into}/{prefix}mean"] = sd[f"{name}.running_mean"]
    flat[f"batch_stats/{into}/{prefix}var"] = sd[f"{name}.running_var"]


def load_torch_cnn_blstm(
    source: StateDictSource, freq_bins: int = 257, device="cpu"
) -> Tuple[StackedBLSTMCNN, Dict[str, np.ndarray]]:
    """``(model, flat)``: a reference CNN+BiLSTM ``state_dict`` (the
    reference's ``model.py:16-107``, or its v2 global-pool lineage) as the
    port's :class:`StackedBLSTMCNN` on ``device`` in eval mode with the
    weights loaded, and the same weights as flat flax variables (what
    ``export_params_npz`` writes).  Layer count, widths, input channels and
    ``global_pool`` come from the tensors' shapes (``port_torch.py:131-206``);
    the frequency bins are the STFT's (``freq_bins``)."""
    sd = reference_state_dict(source)
    n_layers = 1 + max(int(k[len("lstm.weight_ih_l"):].split("_")[0])
                       for k in sd if k.startswith("lstm.weight_ih_l"))
    four_h, lstm_in = sd["lstm.weight_ih_l0"].shape
    hidden = four_h // 4
    enc_out = sd["encoder.6.weight"].shape[0]
    if enc_out != hidden // 2:
        raise ValueError(f"checkpoint encoder output {enc_out} != hidden/2 = {hidden // 2}")
    proj_out = sd["projection.weight"].shape[0]
    dec0_in = sd["decoder.0.weight"].shape[1]
    if proj_out != freq_bins * dec0_in:
        raise ValueError(f"checkpoint projection width {proj_out} is not freq_bins {freq_bins} "
                         f"x {dec0_in} decoder channels")
    if lstm_in not in (enc_out, freq_bins * enc_out):
        raise ValueError(f"checkpoint LSTM input {lstm_in} is neither {enc_out} channels "
                         f"(global pool) nor {freq_bins} x {enc_out}")
    flat: Dict[str, np.ndarray] = {}
    for i, idx in enumerate((0, 3, 6)):
        _conv(sd, f"encoder.{idx}", f"enc_conv{i}", flat)
        _bn(sd, f"encoder.{idx + 1}", f"enc_bn{i}", flat)
    for layer in range(n_layers):
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            name = f"params/lstm/l{layer}_{direction}"
            flat[f"{name}_w_ih"] = np.ascontiguousarray(sd[f"lstm.weight_ih_l{layer}{suffix}"].T)
            flat[f"{name}_w_hh"] = np.ascontiguousarray(sd[f"lstm.weight_hh_l{layer}{suffix}"].T)
            flat[f"{name}_b"] = (sd[f"lstm.bias_ih_l{layer}{suffix}"]
                                 + sd[f"lstm.bias_hh_l{layer}{suffix}"])
    flat["params/projection/kernel"] = np.ascontiguousarray(sd["projection.weight"].T)
    flat["params/projection/bias"] = sd["projection.bias"]
    for i, idx in enumerate((0, 3, 6)):
        _conv(sd, f"decoder.{idx}", f"dec_conv{i}", flat)
    for i, idx in enumerate((1, 4)):
        _bn(sd, f"decoder.{idx}", f"dec_bn{i}", flat)
    return cnn_blstm_from_numpy(flat, device=device), flat


def load_torch_pconv_unet(
    source: StateDictSource,
    enc_layer_cfg: Sequence[Tuple[int, int, int]] = ENC_LAYER_CFG,
    dec_layer_cfg: Sequence[Tuple[int, int, int]] = DEC_LAYER_CFG,
    final_interim_ch: int = 64,
    device="cpu",
) -> Tuple[PConvUNet, Dict[str, np.ndarray]]:
    """``(model, flat)``: a reference PConv U-Net generator ``state_dict``
    (``models/GAN/networks.py:173-345``) as the port's :class:`PConvUNet` on
    ``device`` in eval mode with the weights loaded, and the same weights as
    flat flax variables.  The encoder and decoder partial convolutions carry
    no bias (BatchNorm follows them); the two final ones do."""
    sd = reference_state_dict(source)
    flat: Dict[str, np.ndarray] = {}
    for kind, cfg in (("enc", enc_layer_cfg), ("dec", dec_layer_cfg)):
        prefix = "encoder_blocks" if kind == "enc" else "decoder_blocks"
        for i in range(len(cfg)):
            flat[f"params/{kind}{i}/pconv/conv/kernel"] = _hwio(
                sd[f"{prefix}.{i}.pconv.conv.weight"])
            _bn(sd, f"{prefix}.{i}.norm", f"{kind}{i}", flat, prefix="norm/")
    for name, idx in (("final_pconv1", 0), ("final_pconv2", 2)):
        flat[f"params/{name}/conv/kernel"] = _hwio(sd[f"final_decoder_layer.{idx}.conv.weight"])
        flat[f"params/{name}/bias"] = sd[f"final_decoder_layer.{idx}.bias"]
    model = PConvUNet(enc_layer_cfg=tuple(tuple(c) for c in enc_layer_cfg),
                      dec_layer_cfg=tuple(tuple(c) for c in dec_layer_cfg),
                      final_interim_ch=final_interim_ch)
    model.load_state_dict(pconv_unet_state_dict(flat))
    return model.to(device).eval(), flat


def seeded_reference_cnn_state_dict(seed: int, hidden: int = 128, layers: int = 3,
                                    enc: Sequence[int] = (16, 32), dec: Sequence[int] = (16, 32),
                                    freq: int = 257, in_channels: int = 1,
                                    global_pool: bool = False) -> Dict[str, torch.Tensor]:
    """A reference CNN+BiLSTM ``state_dict`` of random weights drawn from
    ``np.random.default_rng(seed)``, in the reference's layout and shapes
    (full width by default; ``global_pool`` the v2 lineage, whose BiLSTM
    reads the encoder's channels alone): kernels N(0, 1/fan_in), biases and
    BatchNorm shifts N(0, 0.1), BatchNorm scales and variances around 1,
    ``num_batches_tracked`` counters.  The reference's own ``.pt`` files
    are not in the repository; this stands in for them where a checkpoint
    in their layout is needed."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, torch.Tensor] = {}

    def draw(shape, std):
        return torch.tensor(rng.standard_normal(shape) * std, dtype=torch.float32)

    def conv(name, c_in, c_out):
        sd[f"{name}.weight"] = draw((c_out, c_in, 3, 3), 1.0 / np.sqrt(9 * c_in))
        sd[f"{name}.bias"] = draw((c_out,), 0.1)

    def bn(name, c):
        sd[f"{name}.weight"] = 1.0 + draw((c,), 0.1)
        sd[f"{name}.bias"] = draw((c,), 0.1)
        sd[f"{name}.running_mean"] = draw((c,), 0.1)
        sd[f"{name}.running_var"] = 1.0 + draw((c,), 0.1).abs()
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    chans = [in_channels, enc[0], enc[1], hidden // 2]
    for i, idx in enumerate((0, 3, 6)):
        conv(f"encoder.{idx}", chans[i], chans[i + 1])
        bn(f"encoder.{idx + 1}", chans[i + 1])
    d_in = hidden // 2 if global_pool else freq * hidden // 2
    for layer in range(layers):
        for suffix in ("", "_reverse"):
            sd[f"lstm.weight_ih_l{layer}{suffix}"] = draw((4 * hidden, d_in), 1.0 / np.sqrt(d_in))
            sd[f"lstm.weight_hh_l{layer}{suffix}"] = draw((4 * hidden, hidden),
                                                          1.0 / np.sqrt(hidden))
            sd[f"lstm.bias_ih_l{layer}{suffix}"] = draw((4 * hidden,), 0.1)
            sd[f"lstm.bias_hh_l{layer}{suffix}"] = draw((4 * hidden,), 0.1)
        d_in = 2 * hidden
    sd["projection.weight"] = draw((freq * dec[0], 2 * hidden), 1.0 / np.sqrt(2 * hidden))
    sd["projection.bias"] = draw((freq * dec[0],), 0.1)
    conv("decoder.0", dec[0], dec[1])
    bn("decoder.1", dec[1])
    conv("decoder.3", dec[1], dec[0])
    bn("decoder.4", dec[0])
    conv("decoder.6", dec[0], in_channels)
    return sd

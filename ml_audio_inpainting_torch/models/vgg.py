"""VGG19 perceptual and style losses (port of
``ml_audio_inpainting_tpu/models/vgg.py``).

A frozen VGG19 ``features`` stack in torchvision's layout (layer ``N`` is
``features.N``; conv 3x3 padding 1, ReLU, 2x2 max pool), run up to the
deepest captured layer (30): perceptual L1 on the outputs of layers
``PERCEPTUAL_LAYERS``, style L1 on the Gram matrices of ``STYLE_LAYERS``,
after torchvision's ImageClassification preprocessing (shorter side to 256,
bilinear with antialiasing, centre crop 224, ImageNet mean and std).

Weights: without a file, :func:`vgg19_params` draws the JAX package's
initialiser, flax's default ``nn.Conv`` init (``lecun_normal`` kernels,
zero biases; the JAX docstring's "He init" is not what it runs), from seed
42 with a ``torch.Generator``: random-feature losses, as there, and not the
same draws.  ``MAI_VGG19_WEIGHTS`` may name a torchvision ``state_dict``
file, which :func:`load_torch_vgg19` loads as it is (the layouts agree).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ml_audio_inpainting_torch.models.cnn_blstm import _lecun_normal_

__all__ = [
    "VGG19Features",
    "vgg19_params",
    "load_torch_vgg19",
    "preprocess_for_vgg",
    "vgg_perceptual_style_losses",
    "PERCEPTUAL_LAYERS",
    "STYLE_LAYERS",
]

# torchvision vgg19.features: layer index -> conv (in, out); pools; ReLU elsewhere.
VGG19_CONV_LAYERS: Dict[int, Tuple[int, int]] = {
    0: (3, 64), 2: (64, 64),
    5: (64, 128), 7: (128, 128),
    10: (128, 256), 12: (256, 256), 14: (256, 256), 16: (256, 256),
    19: (256, 512), 21: (512, 512), 23: (512, 512), 25: (512, 512),
    28: (512, 512), 30: (512, 512), 32: (512, 512), 34: (512, 512),
}
VGG19_POOL_LAYERS = (4, 9, 18, 27, 36)

PERCEPTUAL_LAYERS = (2, 7, 12, 21, 30)
STYLE_LAYERS = (0, 5, 10, 19, 28)
CAPTURE_LAYERS = tuple(sorted(set(PERCEPTUAL_LAYERS + STYLE_LAYERS)))

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VGG_SEED = 42


class VGG19Features(nn.Module):
    """``forward(x) -> {layer: features}``: x NCHW ``(B, 3, H, W)``, already
    preprocessed; stops after the deepest of ``capture_layers``.  Frozen: no
    parameter requires a gradient, and the module stays in eval mode."""

    def __init__(self, capture_layers: Sequence[int] = CAPTURE_LAYERS):
        super().__init__()
        self.capture_layers = tuple(sorted(set(capture_layers)))
        layers = []
        for idx in range(max(self.capture_layers) + 1):
            if idx in VGG19_CONV_LAYERS:
                layers.append(nn.Conv2d(*VGG19_CONV_LAYERS[idx], 3, padding=1))
            elif idx in VGG19_POOL_LAYERS:
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers.append(nn.ReLU())
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)
        self.eval()

    def train(self, mode: bool = True) -> "VGG19Features":
        return super().train(False)

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        captured = {}
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx in self.capture_layers:
                captured[idx] = x
        return captured


def vgg19_params(
    capture_layers: Sequence[int] = CAPTURE_LAYERS,
    weights_path: Optional[str] = None,
    seed: int = VGG_SEED,
    device="cuda",
) -> VGG19Features:
    """The frozen VGG19 on ``device``: the torchvision weights of
    ``weights_path`` (or of ``MAI_VGG19_WEIGHTS``) if that file exists, else
    flax's default init drawn from a ``torch.Generator`` seeded with
    ``seed``, layer by layer."""
    model = VGG19Features(capture_layers)
    path = weights_path or os.environ.get("MAI_VGG19_WEIGHTS")
    if path and os.path.exists(path):
        load_torch_vgg19(path, model)
    else:
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in model.features:
                if isinstance(layer, nn.Conv2d):
                    _lecun_normal_(layer.weight, layer.weight[0].numel(), gen)
                    layer.bias.zero_()
    return model.to(device)


def load_torch_vgg19(path: str, model: VGG19Features) -> VGG19Features:
    """Load a torchvision VGG19 ``state_dict`` file (``features.N.weight`` and
    ``.bias``; the classifier and layers past the model's depth are
    ignored) into ``model``, read with ``weights_only=True``; every layer of
    the model must be in the file."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"{path} lacks VGG19 weights {missing}")
    model.load_state_dict({k: sd[k] for k in want})
    return model


def _resize_shorter_side(x: torch.Tensor, target: int) -> torch.Tensor:
    """Bilinear antialiased resize of NCHW so the shorter spatial side is
    ``target`` (``jax.image.resize(..., "bilinear", antialias=True)``),
    computed in f32 (or wider) and returned in ``x``'s dtype: JAX contracts
    bf16 input with bf16-rounded weights, and PyTorch's CPU resize has no
    bf16 form."""
    h, w = x.shape[-2:]
    if h <= w:
        size = (target, max(1, int(round(w * target / h))))
    else:
        size = (max(1, int(round(h * target / w))), target)
    wide = x.to(torch.promote_types(x.dtype, torch.float32))
    out = F.interpolate(wide, size=size, mode="bilinear", align_corners=False, antialias=True)
    return out.to(x.dtype)


def _center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    top, left = (h - size) // 2, (w - size) // 2
    return x[..., top:top + size, left:left + size]


def preprocess_for_vgg(
    x: torch.Tensor, is_generated: bool, resize: int = 256, crop: int = 224
) -> torch.Tensor:
    """``(B, F, T)`` spectrogram -> ``(B, 3, crop, crop)`` VGG input, in
    ``x``'s dtype.  Generated inputs (Tanh output) map [-1, 1] -> [0, 1];
    targets are clamped at 0 and divided by their max over the whole batch
    (plus 1e-6) unless that is 1e-5 or less; then clip to [0, 1], resize,
    crop, and ImageNet normalisation into 3 channels."""
    x = x[:, None] if x.ndim == 3 else x
    if is_generated:
        x = (x + 1.0) / 2.0
    else:
        x = torch.clamp_min(x, 0.0)
        max_val = x.max() + 1e-6
        x = torch.where(max_val > 1e-5, x / max_val, x)
    # The three channels are one repeated, so resize one and normalise it thrice.
    x = _center_crop(_resize_shorter_side(torch.clamp(x, 0.0, 1.0), resize), crop)
    return torch.cat([(x - _rounded(m, x.dtype)) / _rounded(s, x.dtype)
                      for m, s in zip(IMAGENET_MEAN, IMAGENET_STD)], dim=1)


def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` on the host, as JAX's constants follow
    the input's dtype; a Python scalar reaches a kernel as an argument, where
    a tensor made on the card would be a synchronising copy."""
    return torch.tensor(value, dtype=dtype).item()


def _gram(feats: torch.Tensor) -> torch.Tensor:
    """Gram matrix ``(B, C, C)`` of NCHW features over the positions,
    divided by ``C * H * W``."""
    b, c, h, w = feats.shape
    f = feats.reshape(b, c, h * w)
    return (f @ f.transpose(1, 2)) / (c * h * w)


def vgg_perceptual_style_losses(
    model: VGG19Features,
    generated: torch.Tensor,
    target: torch.Tensor,
    perceptual_layers: Sequence[int] = PERCEPTUAL_LAYERS,
    style_layers: Sequence[int] = STYLE_LAYERS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(perceptual, style)``: means over the layers of the mean absolute
    difference of the features and of their Gram matrices.  The stack runs
    in the inputs' dtype (the caller casts the model for bf16); the
    reductions run in f32."""
    gen = model(preprocess_for_vgg(generated, is_generated=True))
    tgt = model(preprocess_for_vgg(target, is_generated=False))
    perceptual = torch.stack(
        [(gen[i].float() - tgt[i].float()).abs().mean() for i in perceptual_layers]).mean()
    style = torch.stack(
        [(_gram(gen[i].float()) - _gram(tgt[i].float())).abs().mean() for i in style_layers]
    ).mean()
    return perceptual, style

"""Partial-convolution U-Net generator (port of
``ml_audio_inpainting_tpu/models/pconv_unet.py``).

NCHW with H = frequency and W = time; the public interface stays ``(B, F, T)``
magnitudes and masks (1 = valid / 0 = hole), as in the JAX model.  The mask
algebra is the JAX model's, single-channel:

* the mask state is one channel; a partial conv renormalises by a 1-channel
  ones-conv of the mask's *channel sum* (``_ones_conv``, here a sum pool:
  :func:`ones_conv`), so
  ``ratio = c_in * k * k / (updated + 1e-8)``, the bias comes after the
  ratio and the new mask is ``clip(updated, 0, 1)``;
* at the skip concats each group is pre-multiplied by its own mask and the
  channel sum is ``c_dec * dec_mask + c_skip * skip_mask`` (``premasked``);
* the input is padded to a multiple of the total downsampling, features by
  numpy's reflection (:func:`reflect_pad`) and the mask with ones; the
  final pair of partial convs takes the network input as its skip; Tanh,
  then the crop.

BatchNorm is flax's inference rule (:class:`FlaxBatchNorm2d`, eps 1e-5, the
running statistics).  Where a hole's whole window is masked (``updated ==
0``) the convolution's input is 0 over the window and the JAX model's output
there is an exact 0 (times a ratio of ~1e8 times the window size).  The
ratio is set to 0 at such positions, so the output is that exact 0 whatever
the convolution algorithm leaves there (an FFT or Winograd algorithm mixes
neighbouring windows, and the ratio would multiply its round-off by ~1e8),
and no gradient flows back there.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ml_audio_inpainting_torch.models.cnn_blstm import FlaxBatchNorm2d, _lecun_normal_
from ml_audio_inpainting_torch.utils import precision

__all__ = ["PartialConv", "EncDecBlock", "PConvUNet", "ones_conv", "reflect_pad", "resize_nearest"]

LEAKY_SLOPE = 0.2
MASK_EPS = 1e-8

ENC_LAYER_CFG = ((64, 7, 2), (128, 5, 2), (256, 5, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
                 (512, 3, 2))
DEC_LAYER_CFG = ((512, 3, 1), (512, 3, 1), (512, 3, 1), (256, 3, 1), (128, 3, 1), (64, 3, 1))


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of ``np.pad(range(n), (0, pad), mode="reflect")``: numpy
    reflects again off each end when ``pad >= n``, so the index runs
    periodically with period ``2 (n - 1)``."""
    i = torch.arange(n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    j = i % (2 * (n - 1))
    return torch.where(j < n, j, 2 * (n - 1) - j)


def reflect_pad(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Pad the last two axes of ``x`` at their ends by ``pad_h`` and ``pad_w``
    as ``jnp.pad(..., mode="reflect")`` (numpy's rule) does, which, unlike
    ``F.pad(mode="reflect")``, takes a pad as long as the axis or longer."""
    if pad_h:
        x = x.index_select(-2, _reflect_index(x.shape[-2], pad_h, x.device))
    if pad_w:
        x = x.index_select(-1, _reflect_index(x.shape[-1], pad_w, x.device))
    return x


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(method="nearest")`` of the last two axes: nearest
    neighbour with half-pixel centres, torch's ``nearest-exact``.  Returns
    ``x`` itself when the shape already matches, as after the pad to the
    total downsampling it always does."""
    if x.shape[-2:] == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="nearest-exact")


def ones_conv(mask_sum: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """The convolution of a 1-channel ``mask_sum`` with an all-ones ``kernel x
    kernel`` kernel (``_ones_conv``), zero-padded, as a sum pool: each
    window's sum, accumulated in f32 or wider and rounded once to the
    input's dtype.  The sums are of small integers, so it is exact in f32.
    (cuDNN's bf16 convolution of a 1-channel input gave sums thousands off,
    and other ones on every call, on an H100.)"""
    return F.avg_pool2d(mask_sum, kernel, stride, padding, count_include_pad=True,
                        divisor_override=1)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` through :func:`~ml_audio_inpainting_torch.utils.precision.conv`
    (bf16 on the CPU as an f32 convolution)."""
    return precision.conv(x, conv.weight, conv.bias, stride=conv.stride, padding=conv.padding)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class PartialConv(nn.Module):
    """Masked convolution with receptive-field renormalisation.

    ``forward(x, mask, mask_channel_sum) -> (features, updated_mask)``, with
    the masks single-channel ``(B, 1, H, W)``.  ``mask_channel_sum`` is the
    per-pixel sum of the input mask over ``x``'s channels.  When
    ``premasked``, ``x`` already carries its mask and ``mask`` is unused.
    State-dict keys: ``conv.weight`` (OIHW, no conv bias) and ``bias``.
    """

    def __init__(self, in_channels: int, features: int, kernel: int, stride: int = 1,
                 use_bias: bool = True, premasked: bool = False):
        super().__init__()
        pad = kernel // 2
        self.kernel, self.stride, self.pad = kernel, stride, pad
        self.premasked = premasked
        self.window_size = float(in_channels * kernel * kernel)
        self.conv = nn.Conv2d(in_channels, features, kernel, stride=stride, padding=pad,
                              bias=False)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                mask_channel_sum: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out = _conv(self.conv, x if self.premasked else x * mask)
        updated = ones_conv(mask_channel_sum, self.kernel, self.stride, self.pad)
        out = out * torch.where(updated > 0, self.window_size / (updated + MASK_EPS), 0.0)
        if self.bias is not None:
            out = out + self.bias[:, None, None]
        return out, torch.clamp(updated, 0.0, 1.0)


class EncDecBlock(nn.Module):
    """Partial conv (no bias) -> BatchNorm -> LeakyReLU(0.2)."""

    def __init__(self, in_channels: int, features: int, kernel: int, stride: int,
                 premasked: bool = False):
        super().__init__()
        self.pconv = PartialConv(in_channels, features, kernel, stride, use_bias=False,
                                 premasked=premasked)
        self.norm = FlaxBatchNorm2d(features)

    def forward(self, x, mask, mask_channel_sum):
        x, mask = self.pconv(x, mask, mask_channel_sum)
        return self.norm(x, LEAKY_SLOPE), mask


class PConvUNet(nn.Module):
    """The generator: ``forward(x, mask)`` with ``x`` the ``(B, F, T)``
    log1p magnitude and ``mask`` ``(B, F, T)`` (1 = valid); returns
    ``(B, F, T)`` in [-1, 1] (``(B, C, F, T)`` for ``output_channels > 1``).

    Modules carry the JAX model's names (``enc{i}``, ``dec{i}``,
    ``final_pconv1``, ``final_pconv2``), so ``weights.pconv_unet_state_dict``
    maps the npz keys one to one.
    """

    def __init__(
        self,
        enc_layer_cfg: Sequence[Tuple[int, int, int]] = ENC_LAYER_CFG,
        dec_layer_cfg: Sequence[Tuple[int, int, int]] = DEC_LAYER_CFG,
        final_interim_ch: int = 64,
        final_kernel: int = 3,
        output_channels: int = 1,
    ):
        super().__init__()
        if len(dec_layer_cfg) >= len(enc_layer_cfg):
            raise ValueError(f"{len(dec_layer_cfg)} decoder stages need more than that many "
                             f"encoder stages, got {len(enc_layer_cfg)}")
        self.n_enc, self.n_dec = len(enc_layer_cfg), len(dec_layer_cfg)
        self.output_channels = output_channels
        enc_ch = [ch for ch, _, _ in enc_layer_cfg]
        c_in = 2  # the input and its mask
        for i, (ch, k, s) in enumerate(enc_layer_cfg):
            self.add_module(f"enc{i}", EncDecBlock(c_in, ch, k, s))
            c_in = ch
        for i, (ch, k, s) in enumerate(dec_layer_cfg):
            c_skip = enc_ch[self.n_enc - 2 - i]
            self.add_module(f"dec{i}", EncDecBlock(c_in + c_skip, ch, k, s, premasked=True))
            c_in = ch
        self.final_pconv1 = PartialConv(c_in + 1, final_interim_ch, final_kernel, 1,
                                        use_bias=True, premasked=True)
        self.final_pconv2 = PartialConv(final_interim_ch, output_channels, final_kernel, 1,
                                        use_bias=True)
        self.total_downsampling = 1
        for _, _, s in enc_layer_cfg:
            self.total_downsampling *= s

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Fresh weights with the JAX init's distributions (not its stream),
        flax's defaults: ``lecun_normal`` convolution kernels (a normal
        truncated to two standard deviations, variance 1/fan_in), zero
        partial-convolution biases, BatchNorm scale 1, bias 0, running mean 0
        and variance 1.  Drawn on the CPU from ``generator``, in module
        order.  (torch's own default, ``kaiming_uniform_(a=sqrt(5))``, has a
        third of that variance.)"""
        for module in self.modules():
            if isinstance(module, PartialConv):
                _lecun_normal_(module.conv.weight, module.conv.weight[0].numel(), generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, FlaxBatchNorm2d):
                module.reset_parameters()

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if x.ndim == 3:
            x = x[:, None]
        if mask.ndim == 3:
            mask = mask[:, None]
        h_in, w_in = x.shape[-2:]
        factor = self.total_downsampling
        pad_h, pad_w = (-h_in) % factor, (-w_in) % factor
        x_pad = reflect_pad(x, pad_h, pad_w)
        mask_pad = F.pad(mask, (0, pad_w, 0, pad_h), value=1.0)

        feat, m = torch.cat([x_pad, mask_pad], dim=1), mask_pad
        enc_feats, enc_masks = [], []
        for i in range(self.n_enc):
            feat, m = getattr(self, f"enc{i}")(feat, m, feat.shape[1] * m)
            enc_feats.append(feat)
            enc_masks.append(m)

        dec_feat, dec_mask = enc_feats[-1], enc_masks[-1]
        for i in range(self.n_dec):
            skip_feat, skip_mask = enc_feats[-2 - i], enc_masks[-2 - i]
            h, w = skip_feat.shape[-2:]
            dec_feat = resize_nearest(_upsample2x(dec_feat), h, w)
            dec_mask = resize_nearest(_upsample2x(dec_mask), h, w)
            feat_cat = torch.cat([dec_feat * dec_mask, skip_feat * skip_mask], dim=1)
            mask_sum = dec_feat.shape[1] * dec_mask + skip_feat.shape[1] * skip_mask
            dec_feat, dec_mask = getattr(self, f"dec{i}")(feat_cat, None, mask_sum)
        del enc_feats, enc_masks

        dec_feat, dec_mask = _upsample2x(dec_feat), _upsample2x(dec_mask)
        feat_cat = torch.cat([dec_feat * dec_mask, x_pad * mask_pad], dim=1)
        mask_sum = dec_feat.shape[1] * dec_mask + mask_pad
        del dec_feat
        out, m1 = self.final_pconv1(feat_cat, None, mask_sum)
        del feat_cat
        out = F.leaky_relu(out, LEAKY_SLOPE)
        out, _ = self.final_pconv2(out, m1, self.final_pconv1.conv.out_channels * m1)
        out = torch.tanh(out)[..., :h_in, :w_in]
        return out[:, 0] if self.output_channels == 1 else out

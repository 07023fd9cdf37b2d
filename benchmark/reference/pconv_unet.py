"""Plain forward pass of the PConv U-Net generator (the GAN family), from a
state dict: the yardstick's frozen form of the published architecture.

Layout NCHW, H = frequency, W = time.  A partial convolution convolves the
masked input, renormalises by ``c_in * k * k / (window sum of the mask's
channel sum + 1e-8)`` (0 where that sum is 0, where the masked input is 0
over the whole window), adds its bias after the ratio, and passes on
``clip(window sum, 0, 1)`` as the new one-channel mask.  An encoder or
decoder block is a partial convolution without bias, BatchNorm (eps 1e-5)
and LeakyReLU(0.2).  The input is padded to a multiple of the total
downsampling (features by numpy's reflection, the mask with ones); the
decoder upsamples by two (nearest), concatenates the premasked skip, and
the final pair takes the network input as its skip; Tanh, then the crop.

``q`` is applied to every convolution's input and weight (the identity by
default; the lower-precision control passes a rounding); ``train`` takes
BatchNorm's batch statistics by flax's rule (``E[x^2] - E[x]^2``, clamped
at 0) and returns them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

SLOPE = 0.2
EPS = 1e-5
MASK_EPS = 1e-8


def _identity(x):
    return x


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    i = torch.arange(n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    j = i % (2 * (n - 1))
    return torch.where(j < n, j, 2 * (n - 1) - j)


def batch_norm(x, sd, prefix, train: bool, stats: Optional[dict]):
    w, b = sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]
    if train:
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        if stats is not None:
            stats[prefix] = (mean.detach(), var.detach())
    else:
        mean, var = sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"]
    mul = torch.rsqrt(var + EPS) * w.float()
    y = (x.float() - mean[:, None, None]) * mul[:, None, None] + b.float()[:, None, None]
    return y.to(x.dtype)


def partial_conv(x, mask_sum, weight, bias, stride: int, q: Callable):
    k = weight.shape[-1]
    pad = k // 2
    out = F.conv2d(q(x), q(weight), None, stride=stride, padding=pad)
    ones = torch.ones((1, 1, k, k), dtype=torch.float32, device=x.device)
    updated = F.conv2d(mask_sum.float(), ones, None, stride=stride, padding=pad).to(x.dtype)
    window = float(weight.shape[1] * k * k)
    ratio = torch.where(updated > 0, window / (updated + MASK_EPS), torch.zeros_like(updated))
    out = out * ratio
    if bias is not None:
        out = out + bias[:, None, None]
    return out, torch.clamp(updated, 0.0, 1.0)


def forward(sd: Dict[str, torch.Tensor], x: torch.Tensor, mask: torch.Tensor,
            enc_cfg: Sequence[Tuple[int, int, int]], dec_cfg: Sequence[Tuple[int, int, int]],
            q: Callable = _identity, train: bool = False,
            stats: Optional[dict] = None) -> torch.Tensor:
    """``(B, F, T)`` log1p magnitude and 1 = valid mask -> ``(B, F, T)`` in
    [-1, 1]."""
    x, mask = x[:, None], mask[:, None]
    h_in, w_in = x.shape[-2:]
    factor = 1
    for _, _, s in enc_cfg:
        factor *= s
    ph, pw = (-h_in) % factor, (-w_in) % factor
    x_pad = x.index_select(-2, _reflect_index(h_in, ph, x.device)) if ph else x
    x_pad = x_pad.index_select(-1, _reflect_index(w_in, pw, x.device)) if pw else x_pad
    m_pad = F.pad(mask, (0, pw, 0, ph), value=1.0)

    def block(name, feat, msum, stride):
        out, m = partial_conv(feat, msum, sd[f"{name}.pconv.conv.weight"], None, stride, q)
        return F.leaky_relu(batch_norm(out, sd, f"{name}.norm", train, stats), SLOPE), m

    feat, m = torch.cat([x_pad, m_pad], dim=1), m_pad
    feats, masks = [], []
    for i, (_, _, s) in enumerate(enc_cfg):
        feat, m = block(f"enc{i}", feat * m, feat.shape[1] * m, s)
        feats.append(feat)
        masks.append(m)
    d, dm = feats[-1], masks[-1]
    for i in range(len(dec_cfg)):
        sf, sm = feats[-2 - i], masks[-2 - i]
        d = d.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        dm = dm.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        cat = torch.cat([d * dm, sf * sm], dim=1)
        d, dm = block(f"dec{i}", cat, d.shape[1] * dm + sf.shape[1] * sm, 1)
    d = d.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    dm = dm.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    cat = torch.cat([d * dm, x_pad * m_pad], dim=1)
    out, m1 = partial_conv(cat, d.shape[1] * dm + m_pad, sd["final_pconv1.conv.weight"],
                           sd["final_pconv1.bias"], 1, q)
    out = F.leaky_relu(out, SLOPE)
    out, _ = partial_conv(out * m1, out.shape[1] * m1, sd["final_pconv2.conv.weight"],
                          sd["final_pconv2.bias"], 1, q)
    return torch.tanh(out)[:, 0, :h_in, :w_in]


def param_shapes(enc_cfg, dec_cfg, final_interim: int, final_kernel: int) -> Dict[str, tuple]:
    """Every tensor of the generator's state dict, by the names the served
    module gives them: ``("conv", shape)`` kernels, ``("zero", shape)``
    biases, and BatchNorm's ``("bn_*", shape)``."""
    out: Dict[str, tuple] = {}

    def norm(prefix, ch):
        out.update({f"{prefix}.weight": ("one", (ch,)), f"{prefix}.bias": ("zero", (ch,)),
                    f"{prefix}.running_mean": ("zero", (ch,)),
                    f"{prefix}.running_var": ("one", (ch,)),
                    f"{prefix}.num_batches_tracked": ("count", ())})

    enc_ch, c_in = [ch for ch, _, _ in enc_cfg], 2
    for i, (ch, k, _) in enumerate(enc_cfg):
        out[f"enc{i}.pconv.conv.weight"] = ("conv", (ch, c_in, k, k))
        norm(f"enc{i}.norm", ch)
        c_in = ch
    for i, (ch, k, _) in enumerate(dec_cfg):
        out[f"dec{i}.pconv.conv.weight"] = ("conv", (ch, c_in + enc_ch[len(enc_cfg) - 2 - i], k, k))
        norm(f"dec{i}.norm", ch)
        c_in = ch
    out["final_pconv1.conv.weight"] = ("conv", (final_interim, c_in + 1, final_kernel, final_kernel))
    out["final_pconv1.bias"] = ("zero", (final_interim,))
    out["final_pconv2.conv.weight"] = ("conv", (1, final_interim, final_kernel, final_kernel))
    out["final_pconv2.bias"] = ("zero", (1,))
    return out

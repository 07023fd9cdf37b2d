"""Spectral-norm PatchGAN discriminator (port of
``ml_audio_inpainting_tpu/models/discriminator.py``).

Four convolution blocks (64/128/256 at stride 2, 512 at stride 1, kernel 4,
padding 1, LeakyReLU 0.2, no norm layers) and a final 1-channel convolution,
each spectrally normalised as flax's ``nn.SpectralNorm`` does
(``flax/linen/normalization.py:1104-1181``), which is not
``torch.nn.utils.spectral_norm``:

* the kernel is read as a matrix with one column an output channel
  (flax reshapes HWIO to ``(-1, O)``; here OIHW to ``(O, -1)``, the same
  matrix transposed with its rows in another order), and ``u`` is ``(1, O)``;
* every call runs one power-iteration step from the stored ``u``, in train
  and eval mode alike: ``v = l2n(u W^T)``, ``u' = l2n(v W)``, then
  ``sigma = v W u'^T``; ``u'`` and ``v`` carry no gradient, ``sigma`` does
  (through W), and the kernel is divided by ``sigma`` where it is nonzero;
* ``u'`` and ``sigma`` are stored only when the caller asks
  (``update_stats``); biases are left alone.

The power-iteration state is a buffer pair on each convolution, ``u`` and
``sigma``, so flax's ``batch_stats/SpectralNorm_{i}/{name}/kernel/u`` is
``{name}.u`` here (``weights.discriminator_state_dict``).
:meth:`Discriminator.apply_sn` is the functional form the train step
differentiates: weights and ``u`` vectors in, logits and the new state out.

Layout: NCHW inside; ``(B, F, T)`` in, logits ``(B, 1, F', T')`` out (the
JAX model returns ``(B, F', T', 1)``; the losses take means, which do not
see the order).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ml_audio_inpainting_torch.models.cnn_blstm import _lecun_normal_

__all__ = ["Discriminator", "spectral_normalize"]

LEAKY_SLOPE = 0.2
SN_EPS = 1e-12  # flax SpectralNorm's epsilon
LAYER_CFG = ((64, 2), (128, 2), (256, 2), (512, 1))


def _l2_normalize(x: torch.Tensor, eps: float = SN_EPS) -> torch.Tensor:
    """flax's ``_l2_normalize`` over the whole tensor: ``x * rsqrt(sum(x^2) + eps)``."""
    return x * torch.rsqrt((x * x).sum() + eps)


def spectral_normalize(
    weight: torch.Tensor, u: torch.Tensor, eps: float = SN_EPS
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(weight / sigma, u', sigma)``: one power-iteration step from ``u``
    ``(1, O)`` on the OIHW ``weight`` read as ``(O, -1)``, as flax's
    ``SpectralNorm._spectral_normalize`` with ``n_steps=1``.  ``u'`` is
    detached; ``sigma`` (0-d) is differentiable through ``weight``."""
    w_mat = weight.reshape(weight.shape[0], -1)  # (O, K): flax's (K, O) transposed
    with torch.no_grad():
        v = _l2_normalize(u @ w_mat, eps)  # (1, K)
        u_new = _l2_normalize(v @ w_mat.t(), eps)  # (1, O)
    sigma = ((v @ w_mat.t()) @ u_new.t())[0, 0]
    return weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma)), u_new, sigma


class Discriminator(nn.Module):
    """``forward(x, update_stats=False)``: ``(B, F, T)`` magnitudes (or
    ``(B, 1, F, T)``) -> patch logits ``(B, 1, F', T')``.

    Convolutions are named as the JAX model's (``block{i}_conv``,
    ``final_conv``); with spectral norm each holds buffers ``u`` ``(1, O)``
    and ``sigma`` ``()``."""

    def __init__(
        self,
        layer_cfg: Sequence[Tuple[int, int]] = LAYER_CFG,
        kernel_size: int = 4,
        use_spectral_norm: bool = True,
        input_channels: int = 1,
    ):
        super().__init__()
        self.use_spectral_norm = use_spectral_norm
        self.names: List[str] = []
        c_in = input_channels
        for i, (ch, stride) in enumerate(layer_cfg):
            self._add_conv(f"block{i}_conv", c_in, ch, kernel_size, stride)
            c_in = ch
        self._add_conv("final_conv", c_in, 1, kernel_size, 1)

    def _add_conv(self, name: str, c_in: int, c_out: int, kernel: int, stride: int) -> None:
        conv = nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=1)
        if self.use_spectral_norm:
            conv.register_buffer("u", torch.zeros(1, c_out))
            conv.register_buffer("sigma", torch.ones(()))
        self.add_module(name, conv)
        self.names.append(name)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Fresh weights with the JAX init's distributions (not its stream):
        ``lecun_normal`` kernels, zero biases, ``u ~ N(0, 1)`` and ``sigma =
        1`` (flax's ``SpectralNorm`` variables).  flax's init stores the
        kernel it normalised: the draw divided by the sigma of one power step
        from the drawn ``u`` (which is stored as drawn), so a fresh JAX
        kernel has a largest singular value near 1, not the draw's; so does
        this one.  Drawn on the CPU from ``generator``, in module order."""
        for name in self.names:
            conv = getattr(self, name)
            _lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
            conv.bias.zero_()
            if self.use_spectral_norm:
                conv.u.copy_(torch.randn(conv.u.shape, generator=generator))
                conv.sigma.fill_(1.0)
                conv.weight.copy_(spectral_normalize(conv.weight, conv.u)[0])

    def sn_state(self) -> List[torch.Tensor]:
        """The stored ``u`` of each convolution, in order (empty without
        spectral norm)."""
        return [getattr(self, n).u for n in self.names] if self.use_spectral_norm else []

    @torch.no_grad()
    def store_sn_state(self, us: Sequence[torch.Tensor], sigmas: Sequence[torch.Tensor]) -> None:
        """Store ``us`` and ``sigmas`` (any dtype) into the f32 buffers."""
        for name, u, sigma in zip(self.names, us, sigmas):
            conv = getattr(self, name)
            conv.u.copy_(u)
            conv.sigma.copy_(sigma)

    def apply_sn(
        self, params: Mapping[str, torch.Tensor], us: Sequence[torch.Tensor], x: torch.Tensor
    ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
        """``(logits, us', sigmas)`` of ``x`` under ``params`` (``{name}.weight``
        and ``{name}.bias``, e.g. bf16 casts of the module's) and power-iteration
        vectors ``us``; stores nothing."""
        if x.ndim == 3:
            x = x[:, None]
        new_us, sigmas = [], []
        for i, name in enumerate(self.names):
            conv = getattr(self, name)
            weight = params[f"{name}.weight"]
            if self.use_spectral_norm:
                weight, u, sigma = spectral_normalize(weight, us[i])
                new_us.append(u)
                sigmas.append(sigma)
            x = F.conv2d(x, weight, params[f"{name}.bias"], stride=conv.stride,
                         padding=conv.padding)
            if name != "final_conv":
                x = F.leaky_relu(x, LEAKY_SLOPE)
        return x, new_us, sigmas

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        params: Dict[str, torch.Tensor] = dict(self.named_parameters())
        logits, us, sigmas = self.apply_sn(params, self.sn_state(), x)
        if update_stats and self.use_spectral_norm:
            self.store_sn_state(us, sigmas)
        return logits

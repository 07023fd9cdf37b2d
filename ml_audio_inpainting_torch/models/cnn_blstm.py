"""CNN encoder -> BiLSTM bottleneck -> CNN decoder (port of
``ml_audio_inpainting_tpu/models/cnn_blstm.py::StackedBLSTMCNN``).

The convs run in NCHW with H = frequency and W = time; the public interface
stays the JAX model's: ``(B, F, T)`` log spectrograms, or ``(B, F, T, C)``
channels last (the phase-mode model's stacked real and imaginary STFT,
``in_channels=2``), permuted inside.  The JAX model works in NHWC ``(B, F,
T, C)``, so the two reshapes around the BiLSTM follow its element order
exactly:

* into the sequence, JAX flattens ``(B, F, T, C) -> (B, T, C, F) -> (B, T, C*F)``,
  so here ``(B, C, F, T) -> (B, T, C, F)`` before the flatten; with
  ``global_pool`` (the v2-era lineage, ``cnn_blstm.py:71-74``) it takes the
  mean over F instead, so the BiLSTM sees ``(B, T, C)``;
* out of the projection, JAX reads ``(B, T, C*F)`` as ``(B, T, C, F)`` and
  moves it to ``(B, F, T, C)``, so here ``(B, T, C, F) -> (B, C, F, T)``.

BatchNorm follows flax's ``nn.BatchNorm`` (:class:`FlaxBatchNorm2d`): eps
1e-5, and in train mode it normalises with the batch statistics and updates
the running ones with momentum 0.99 and the *biased* batch variance.  A 3x3
SAME conv is padding 1.  Like any ``nn.Module`` the model is built in train
mode; the serving entry points put it in eval mode.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence

import torch
from torch import nn

from ml_audio_inpainting_torch.ops.cuda import batchnorm
from ml_audio_inpainting_torch.ops.lstm import BiLSTM
from ml_audio_inpainting_torch.parallel.collectives import column_parallel_linear

__all__ = ["FlaxBatchNorm2d", "StackedBLSTMCNN", "running_stats_frozen"]

BN_EPS = 1e-5  # flax.linen.BatchNorm default
BN_MOMENTUM = 0.99  # flax.linen.BatchNorm default: running = 0.99 * running + 0.01 * batch
TRUNC_NORMAL_STD = 0.87962566103423978  # std of N(0, 1) truncated to [-2, 2]


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode rule, written out here.

    Train mode (``ml_audio_inpainting_tpu/models/cnn_blstm.py:66,90,93``,
    flax 0.12 defaults): ``mean = E[x]`` and ``var = max(E[x^2] - mean^2, 0)``
    over (N, H, W) (flax's ``use_fast_variance``), ``y = (x - mean) *
    (rsqrt(var + eps) * scale) + bias``, and the running statistics move by
    ``m * running + (1 - m) * batch`` with ``m = 0.99`` and the *biased*
    ``var`` (torch's own rule takes momentum 0.1 and the unbiased variance).
    Eval mode is torch's (cuDNN) normalisation with the running statistics.
    The state-dict keys are ``nn.BatchNorm2d``'s.

    In bf16 (``x``, and the scale and bias, cast to bf16 by the mixed-precision
    train step) train mode follows flax's ``force_float32_reductions``: the
    batch mean and variance are taken over ``x.float()``, the running
    statistics stay f32 and move in f32, and ``y`` is computed in f32 (the
    bf16 scale and bias upcast) and returned in ``x``'s type.  For f32 (and
    f64) input every cast is the identity and the result is the f32 rule's.

    ``update_running`` (True) says whether a train-mode forward moves the
    running statistics; :func:`running_stats_frozen` clears it for a forward
    that repeats one whose update was already kept.

    ``forward(x, negative_slope)`` also applies the activation that follows
    the layer: none for None, ``torch.relu`` for 0, ``F.leaky_relu`` with
    that slope otherwise.  Train mode runs the rule and the activation as
    one ``torch.autograd.Function`` (``ops/cuda/batchnorm.py``: hand-written
    kernels on the card, its plain version on the CPU), with the mean taken
    over a mesh's global batch; eval mode applies the activation to
    cuDNN's output as a plain op.  The Function is called through its
    module, where a branch tape (``utils/branch_tape.py``) wraps it.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)
        self.update_running = True

    def forward(self, x: torch.Tensor, negative_slope: Optional[float] = None) -> torch.Tensor:
        if not self.training:
            return batchnorm.activate(super().forward(x), negative_slope)
        return batchnorm.batch_norm_act(x, self.weight, self.bias, self.running_mean,
                                        self.running_var, self.num_batches_tracked,
                                        self.update_running, self.eps, BN_MOMENTUM,
                                        negative_slope=negative_slope)


@contextlib.contextmanager
def running_stats_frozen(module: nn.Module, frozen: bool = True) -> Iterator[None]:
    """A scope in which the train-mode forwards of ``module``'s
    :class:`FlaxBatchNorm2d` layers normalise with their batch statistics
    but leave the running ones as they are (with ``frozen=False``, a scope
    that changes nothing); the switches are restored on exit.  A flax step
    keeps the ``batch_stats`` of one forward of its choice; a torch module
    updates them on every train-mode forward, so a step that runs the same
    forward again (the GAN's G step after the D step's detached forward, a
    checkpointed forward recomputed in the backward) runs it in here."""
    norms = [m for m in module.modules() if isinstance(m, FlaxBatchNorm2d)]
    before = [m.update_running for m in norms]
    for m in norms:
        m.update_running = not frozen and m.update_running
    try:
        yield
    finally:
        for m, flag in zip(norms, before):
            m.update_running = flag


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init ``lecun_normal``: a normal truncated to
    two standard deviations, scaled so its variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / TRUNC_NORMAL_STD
    draw = torch.empty(w.shape)
    nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    w.copy_(draw)


class StackedBLSTMCNN(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        num_lstm_layers: int = 3,
        lstm_hidden_dim: int = 128,
        freq_bins: int = 257,
        enc_filters: Sequence[int] = (16, 32),
        dec_filters: Sequence[int] = (16, 32),
        global_pool: bool = False,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.global_pool = global_pool
        self.dec_filters = tuple(dec_filters)
        enc_channels = list(enc_filters) + [lstm_hidden_dim // 2]
        c_in = in_channels
        for i, ch in enumerate(enc_channels):
            self.add_module(f"enc_conv{i}", nn.Conv2d(c_in, ch, 3, padding=1))
            self.add_module(f"enc_bn{i}", FlaxBatchNorm2d(ch))
            c_in = ch
        self.num_enc = len(enc_channels)
        self.lstm = BiLSTM(c_in if global_pool else freq_bins * c_in, lstm_hidden_dim,
                           num_lstm_layers)
        self.projection = nn.Linear(2 * lstm_hidden_dim, freq_bins * self.dec_filters[0])
        self.dec_conv0 = nn.Conv2d(self.dec_filters[0], self.dec_filters[1], 3, padding=1)
        self.dec_bn0 = FlaxBatchNorm2d(self.dec_filters[1])
        self.dec_conv1 = nn.Conv2d(self.dec_filters[1], self.dec_filters[0], 3, padding=1)
        self.dec_bn1 = FlaxBatchNorm2d(self.dec_filters[0])
        self.dec_conv2 = nn.Conv2d(self.dec_filters[0], in_channels, 3, padding=1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Fresh weights with the JAX init's distributions (not its stream):
        ``lecun_normal`` conv and dense kernels with zero biases (flax's
        defaults), BatchNorm scale 1, bias 0, running mean 0 and variance 1,
        and the BiLSTM's U[0, 2/sqrt(H)) (:meth:`BiLSTM.init_weights`).  Drawn
        on the CPU from ``generator``, in module order."""
        for name, module in self.named_children():
            if isinstance(module, nn.Conv2d):
                _lecun_normal_(module.weight, module.weight[0].numel(), generator)
                module.bias.zero_()
            elif isinstance(module, nn.Linear):
                _lecun_normal_(module.weight, module.in_features, generator)
                module.bias.zero_()
            elif isinstance(module, FlaxBatchNorm2d):
                module.reset_parameters()
            elif isinstance(module, BiLSTM):
                module.init_weights(generator)
            else:
                raise TypeError(f"no init rule for {name}: {type(module).__name__}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, F, T)`` -> ``(B, F, T)``, or ``(B, F, T, C)`` -> ``(B, F, T,
        in_channels)`` (as the JAX model: a 3-D input is one channel)."""
        squeeze = x.dim() == 3
        h = x[:, None] if squeeze else x.permute(0, 3, 1, 2)  # (B, C, F, T)
        B, _, F, T = h.shape
        for i in range(self.num_enc):
            h = getattr(self, f"enc_conv{i}")(h)  # (the input is freed before the norm runs)
            h = getattr(self, f"enc_bn{i}")(h, 0.0)  # ReLU

        if self.global_pool:
            seq = h.mean(dim=2).transpose(1, 2)  # (B, T, C)
        else:
            seq = h.permute(0, 3, 1, 2).reshape(B, T, -1)  # (B, T, C*F), JAX's order
        seq = self.lstm(seq)
        # (B, T, dec0*F); column-parallel where a mesh splits the weight's rows
        seq = column_parallel_linear(seq, self.projection.weight, self.projection.bias)
        h = seq.reshape(B, T, self.dec_filters[0], F).permute(0, 2, 3, 1)  # (B, dec0, F, T)

        h = self.dec_conv0(h)
        h = self.dec_bn0(h, 0.0)  # ReLU
        h = self.dec_conv1(h)
        h = self.dec_bn1(h, 0.0)
        h = self.dec_conv2(h)
        return h[:, 0] if squeeze else h.permute(0, 2, 3, 1)

    def reconstruct_spectrogram(self, x: torch.Tensor, gap_mask: torch.Tensor) -> torch.Tensor:
        """The prediction inside the gap (``gap_mask`` 1), the input outside
        it, the model in eval mode (``cnn_blstm.py:99-115``).  In phase mode
        ``x`` is ``(B, F, T, 2)`` real and imaginary channels and the result
        is the complex ``(B, F, T)`` composite."""
        was_training = self.training
        self.eval()
        try:
            pred = self(x)
        finally:
            self.train(was_training)
        if self.in_channels == 2:
            pred_c = torch.complex(pred[..., 0], pred[..., 1])
            in_c = torch.complex(x[..., 0], x[..., 1])
            return pred_c * gap_mask + in_c * (1.0 - gap_mask)
        return pred * gap_mask + x * (1.0 - gap_mask)

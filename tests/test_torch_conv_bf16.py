"""The port's bf16 convolutions on the CPU (``utils/precision.py::conv``),
under a dispatch mode that fills freed memory with NaN before every op.

oneDNN's bf16 convolution, forward and backward, can leave outputs
unwritten, so they hold whatever their memory held: under the poisoning,
``aten.convolution_backward`` of the PatchGAN's last layer (input ``(2,
16, 127, 30)``, weight ``(1, 16, 4, 4)``, finite bf16 values) came back
non-finite in most seeded runs.  The port runs a bf16 convolution on the
CPU as the f32 convolution of the same values, rounded once to bf16.  Held
here, under the poisoning: every output and gradient finite, and within
bf16 rounding (2**-8 of each value, plus 1e-6 of the tensor's peak for the
different sum order) of the f32 convolution of the upcast values; the
generator's one-column case (once worked round in ``models/pconv_unet.py``;
``tests/test_torch_pconv_unet.py`` holds its witness under
``MALLOC_PERTURB_``) among the shapes; and a bf16 GAN train step of the
tiny config finite.  With oneDNN's bf16 convolution put back in place of
the rule, the ``d-final`` case fails here (its weight gradient non-finite).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from test_gan import tiny_gan_config

from torch_threads import one_thread  # noqa: F401  (a module fixture)

from ml_audio_inpainting_torch.train.gan_trainer import create_gan_states, make_gan_train_step
from ml_audio_inpainting_torch.train.recipe import gan_gap_layouts
from ml_audio_inpainting_torch.utils import precision
from ml_audio_inpainting_torch.utils.config import Config

BF16_REL = 2.0**-8
ORDER_REL = 1e-6


class FreedMemoryPoison(TorchDispatchMode):
    """Before each op, allocate and free NaN buffers the sizes of the op's
    tensor arguments (and of ``sizes``), so a fresh allocation that reuses
    freed memory starts out NaN."""

    def __init__(self, sizes=(2 * 16 * 127 * 30, 1 << 12, 1 << 16, 1 << 20)):
        super().__init__()
        self.sizes = set(sizes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        sizes = {a.numel() for a in args if isinstance(a, torch.Tensor)} | self.sizes
        for n in sizes:
            for dtype in (torch.float32, torch.bfloat16):
                del_me = torch.full((max(n, 1),), float("nan"), dtype=dtype)
                del del_me
        return func(*args, **(kwargs or {}))


# (input shape, weight shape, stride, padding, dilation): D's final conv (the
# recorded fault), D's first block, the generator's one-column last encoder
# stage at 1 s, a VGG-like 3x3, and the refiner's dilated 1-D convolution.
SHAPES = [
    ((2, 16, 127, 30), (1, 16, 4, 4), 1, 1, 1),
    ((2, 1, 257, 126), (8, 1, 4, 4), 2, 1, 1),
    ((2, 128, 8, 2), (128, 128, 3, 3), 2, 1, 1),
    ((1, 64, 32, 40), (64, 64, 3, 3), 1, 1, 1),
    ((2, 16, 600), (16, 16, 3), 1, 64, 64),
]


@pytest.mark.parametrize("shape", SHAPES, ids=["d-final", "d-first", "g-one-column", "vgg",
                                               "conv1d-dilated"])
def test_bf16_conv_forward_and_backward_finite_under_poisoning(shape):
    xs, ws, stride, padding, dilation = shape
    gen = torch.Generator().manual_seed(sum(xs))
    x32 = torch.randn(xs, generator=gen)
    w32 = torch.randn(ws, generator=gen) / np.sqrt(np.prod(ws[1:]))
    b32 = torch.randn(ws[0], generator=gen) * 0.1
    x, w, b = (t.bfloat16().requires_grad_() for t in (x32, w32, b32))
    kw = dict(stride=stride, padding=padding, dilation=dilation)
    with FreedMemoryPoison():
        y = precision.conv(x, w, b, **kw)
        gy = torch.randn(y.shape, generator=gen).bfloat16()
        gx, gw, gb = torch.autograd.grad(y, (x, w, b), gy)
    assert y.dtype == gx.dtype == gw.dtype == gb.dtype == torch.bfloat16
    fn = F.conv1d if len(ws) == 3 else F.conv2d
    xr, wr, br = (t.detach().float().requires_grad_() for t in (x, w, b))
    yr = fn(xr, wr, br, **kw)
    gxr, gwr, gbr = torch.autograd.grad(yr, (xr, wr, br), gy.float())
    for name, got, want in (("y", y, yr), ("dx", gx, gxr), ("dw", gw, gwr), ("db", gb, gbr)):
        got, want = got.float(), want.detach()
        assert torch.isfinite(got).all(), name
        bound = BF16_REL * want.abs() + ORDER_REL * want.abs().max()
        assert ((got - want).abs() <= bound).all(), (name, ((got - want).abs() - bound).max())


def test_bf16_gan_step_on_the_cpu_stays_finite_under_poisoning():
    """A bf16 train step of the tiny GAN (G, D, no VGG) on the CPU under
    the poisoning (the sizes of each op's arguments): finite losses and
    parameters."""
    jcfg = tiny_gan_config()
    cfg = Config.from_dict(jcfg.to_dict())
    g, d = create_gan_states(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    step = make_gan_train_step(cfg, compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(1)
    audio = torch.randn((2, cfg.data.max_samples), generator=gen) * 0.3
    with FreedMemoryPoison(sizes=()):
        g, d, metrics = step(g, d, audio, *gan_gap_layouts(gen, cfg, 2))
    assert all(torch.isfinite(v).all() for v in metrics.values()), metrics
    assert all(torch.isfinite(p).all() for p in (*g.model.parameters(), *d.model.parameters()))

"""Tests of the port that need a CUDA card and ``nvcc``; each skips without a
card.  This file imports neither JAX nor ``tests/conftest.py``'s fixtures, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: the forward kernel's h and c against its plain version,
``atol=1e-4`` (f32 dots over H in the kernel's k-slice order against
cuBLAS', through up to 417 steps); two launches of it agree bit for bit.  The backward kernel's ``dxw``, ``atol=1e-4`` (the same,
over the reverse sweep); the dW_hh reduction, within 1e-4 of the largest
entry of dW_hh (a sum over B*T terms in another order).  Two launches of the
backward kernels on the same inputs agree bit for bit (no atomics, fixed
summation orders).  The serving path on the card against the same path on
the CPU, ``atol=1e-4`` on waveforms of peak 1 (every sum in another order;
TF32 off, and also with torch's global TF32 defaults, which the serving
entry point overrides for its convolutions).  A training step on the card
against the CPU: the loss to 1e-4 relative and each gradient within 1e-3 of
its largest entry (conv biases in front of BatchNorm, whose exact gradient is
zero, within 1e-3 of the model's largest gradient entry).  GAN serving on the
card against the CPU in f32: the generator's Tanh output within ``2e-4`` and
the waveform within ``1e-4`` (cuDNN's own convolution algorithms sum up to
9216 products in another order, and at positions whose window is all hole a
ratio of up to ~1e10 multiplies their round-off before the next layer's
mask zeroes it); in bf16 against bf16 on the CPU, ``6e-2`` and ``1e-3``;
two requests of the GAN runner agree bit for bit, in f32 and in bf16.

The bf16 forms of the LSTM kernels against their plain versions in bf16 on
the card: every bf16 output (h, c, dxw, dW_hh) within one bf16 ulp of the
plain version's plus the f32 bound above (``1e-4``, for dW_hh ``1e-4`` of
its largest entry): both carry and sum in f32 and differ there as the f32
kernels do, and one rounding to bf16 can then land one ulp apart; the pair
``(dxw, lo)`` the bf16 backward kernel writes for dW_hh sums to within
``1e-4`` of the plain version's f32 dgates.  Two bf16 launches agree bit for
bit.  The bf16 forward is the tensor-core kernel, held to the plain
version whose product takes h as the same three bf16 pieces.  The f32
forward and backward kernels give, on seeded inputs, the outputs they gave
before the bf16 forms got kernels of their own, bit for bit (sha256
digests taken on an H100).  A bf16 train step of a narrow model on the
card launches only the bf16 forms, and its loss lies within ``rtol=5e-2``
of the f32 step's (bf16 rounding through the network: 1.8e-2 on the CPU
for the same batch).
"""

import copy
import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

from ml_audio_inpainting_torch.models.build import build_generator
from ml_audio_inpainting_torch.models.cnn_blstm import StackedBLSTMCNN
from ml_audio_inpainting_torch.ops.cuda import lstm_cell
from ml_audio_inpainting_torch.runtime import profiling
from ml_audio_inpainting_torch.runtime.inference import make_gan_inpaint_fn
from ml_audio_inpainting_torch.runtime.serve import make_cnn_runner, make_gan_runner
from ml_audio_inpainting_torch.runtime.synthetic import (
    GAP_LEN,
    GAP_START,
    gan_config,
    speech_like_batch,
    synthetic_dataset_batch,
)
from ml_audio_inpainting_torch.runtime.transport import DEFAULT_PATCH_WINDOW, make_gap_transport_fn
from ml_audio_inpainting_torch.train.cnn_trainer import create_cnn_state, make_cnn_train_step
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.weights import cnn_blstm_flat_variables

from span_stages import outside_stages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "results", "checkpoints", "cnn_blstm_formant_v2_r2.npz")
GAN_CKPT = os.path.join(REPO, "results", "checkpoints", "gan_formant_v2_r2.npz")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; on one: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launches(kernel: str, bf16_only: bool = False) -> int:
    """``kernel``'s launches since the last reset (``lstm_cell.kernel_launches``),
    in both forms or in bf16 alone."""
    counts = lstm_cell.kernel_launches()
    return counts[f"{kernel}_bf16"] + (0 if bf16_only else counts[kernel])


def _on_card(device, *arrays):
    return [torch.tensor(a, device=device) for a in arrays]


def _forward_inputs(device, B, T, H):
    """Seeded xw and W_hh of both directions on the card."""
    rng = np.random.default_rng(B)
    xw_f, xw_b = (rng.standard_normal((B, T, 4 * H)).astype(np.float32) for _ in range(2))
    w_f, w_b = ((rng.standard_normal((H, 4 * H)) * 0.1).astype(np.float32) for _ in range(2))
    return _on_card(device, xw_f, w_f, xw_b, w_b)


def _check_forward(got_h, got_c, xw_f, w_f, xw_b, w_b):
    want_h, want_c = lstm_cell.bilstm_recurrence_reference(xw_f, w_f, xw_b, w_b, return_c=True)
    np.testing.assert_allclose(got_h.cpu().numpy(), want_h.cpu().numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_c.cpu().numpy(), want_c.cpu().numpy(), rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H", [
    (32, 417, 128),  # serving: 8 clusters of 8 CTAs a direction
    (25, 417, 128),  # training: 7 clusters, the last with one live row
    (128, 417, 128),  # the batch of cnn_blstm_formant_v2_b128_r4.npz
    (5, 29, 16),  # B not a multiple of the rows of a cluster; 2 units a CTA
    (1, 33, 128),  # B=1: a cluster with one live row
    (6, 1, 128),  # T=1: no carry
    (3, 11, 4),  # H=4: clusters of 4 CTAs, 1 unit each, 4-byte xw copies
    (7, 23, 12),  # H=12: 3 units a CTA (odd), the last k-slice empty
    (3, 19, 124),  # H=124: 31 units a CTA, 2 k-slices of 64
])
def test_kernel_matches_plain_on_card(cuda_device, B, T, H):
    """h and c of both directions (each half of the (B, T, 2H) outputs)
    against the plain version of its direction, at shapes that reach the
    edges of the cluster plan; and the entry point's h is the same launch's."""
    xw_f, w_f, xw_b, w_b = _forward_inputs(cuda_device, B, T, H)
    before = _launches("lstm_fwd")
    h, c = lstm_cell.bilstm_forward(xw_f, w_f, xw_b, w_b, with_c=True)
    got = lstm_cell.bilstm_recurrence(xw_f, w_f, xw_b, w_b)
    torch.cuda.synchronize()
    assert _launches("lstm_fwd") == before + 2
    assert h.shape == c.shape == got.shape == (B, T, 2 * H)
    assert torch.equal(got, h)
    _check_forward(h, c, xw_f, w_f, xw_b, w_b)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", lstm_cell.FWD_ROW_CHOICES)
@pytest.mark.parametrize("B,T,H", [(25, 417, 128), (7, 23, 12), (3, 19, 124)])
def test_forward_kernel_row_choices_match_plain(cuda_device, rows, B, T, H):
    """Every number of batch rows a cluster the launcher instantiates gives
    the plain version's h and c, and the default plan's bit for bit."""
    xw_f, w_f, xw_b, w_b = _forward_inputs(cuda_device, B, T, H)
    h, c = lstm_cell.bilstm_forward(xw_f, w_f, xw_b, w_b, with_c=True, rows=rows)
    default = lstm_cell.bilstm_forward(xw_f, w_f, xw_b, w_b, with_c=True)
    torch.cuda.synchronize()
    _check_forward(h, c, xw_f, w_f, xw_b, w_b)
    assert torch.equal(h, default[0]) and torch.equal(c, default[1])


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H", [(32, 417, 128), (7, 23, 12)])
def test_forward_kernel_is_deterministic(cuda_device, B, T, H):
    """Two launches on the same inputs give the same h and c, bit for bit."""
    xw_f, w_f, xw_b, w_b = _forward_inputs(cuda_device, B, T, H)
    first = lstm_cell.bilstm_forward(xw_f, w_f, xw_b, w_b, with_c=True)
    second = lstm_cell.bilstm_forward(xw_f, w_f, xw_b, w_b, with_c=True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.gpu
@pytest.mark.parametrize("change", [
    {"rows": 3, "groups": 11},  # no such instantiation (11 x 3 rows cover B=32)
    {"cluster": 3},  # does not divide H
    {"cluster": 16},  # above the portable cluster size
    {"ksplit": 3},  # the kernel splits a gate over 4 or 2 lanes
    {"ksplit": 8},  # 8 lanes x 64 columns > 256 threads
    {"groups": 1},  # too few clusters for B=32
    {"groups": 17},  # more clusters than B=32 needs at 2 rows a cluster
])
def test_forward_launcher_refuses_a_plan_it_cannot_run(cuda_device, monkeypatch, change):
    """The launcher checks the plan it is given and launches nothing on one
    it cannot run; the wrapper raises with the plan in the message."""
    xw_f, w_f, xw_b, w_b = _forward_inputs(cuda_device, 32, 5, 128)
    good = lstm_cell.fwd_plan(32, 128)
    bad = dataclasses.replace(good, **change)
    monkeypatch.setattr(lstm_cell, "fwd_plan", lambda b, hh, rows: bad)
    before = _launches("lstm_fwd")
    with pytest.raises(RuntimeError, match=r"lstm_fwd launch failed with CUDA error 1 .*ClusterPlan"):
        lstm_cell.bilstm_forward(xw_f, w_f, xw_b, w_b)
    assert _launches("lstm_fwd") == before


@pytest.mark.gpu
@pytest.mark.parametrize("H", [4, 12, 16, 68, 100, 124, 128])
def test_forward_plan_shared_memory_matches_the_source(cuda_device, H):
    """The Python mirrors of FwdLayout (f32) and MmaFwdLayout (bf16) give
    the bytes the launchers ask for."""
    cdll = lstm_cell.load_library("lstm_fwd").cdll
    for rows in lstm_cell.FWD_ROW_CHOICES:
        plan = lstm_cell.fwd_plan(32, H, rows)
        assert cdll.lstm_fwd_smem_bytes(H, rows, plan.cluster, plan.ksplit) == (
            lstm_cell.fwd_smem_bytes(plan))
    plan = lstm_cell.fwd_mma_plan(32, H)
    assert cdll.lstm_fwd_mma_smem_bytes(H, plan.rows, plan.cluster) == (
        lstm_cell.fwd_mma_layout(plan).smem_bytes)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    half = torch.zeros((2, 3, 64), device=cuda_device, dtype=torch.float16)
    w_half = torch.zeros((16, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32"):
        lstm_cell.bilstm_recurrence(half, w_half, half, w_half)
    xw = torch.zeros((2, 3, 24), device=cuda_device)
    w_hh = torch.zeros((6, 24), device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 4"):
        lstm_cell.bilstm_recurrence(xw, w_hh, xw, w_hh)


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["oracle", "impaired"])
def test_serving_on_card_matches_cpu(cuda_device, phase):
    rng = np.random.default_rng(13)
    audio = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    starts, lens = np.array([3000, 8000]), np.array([1280, 1280])
    card = make_cnn_runner(Config(), CKPT, device=cuda_device, phase=phase)
    before = _launches("lstm_fwd")
    got = card(audio, starts, lens).cpu().numpy()
    assert _launches("lstm_fwd") == before + 3  # one a layer
    want = make_cnn_runner(Config(), CKPT, device="cpu", phase=phase)(audio, starts, lens).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_serving_runs_full_f32_under_global_tf32_defaults(cuda_device):
    """With torch's own defaults (cuDNN convolutions in TF32, matmuls in
    f32) the runner still matches the CPU within the f32 tolerance: it runs
    its convolutions with TF32 off, whatever the global switch says."""
    rng = np.random.default_rng(14)
    audio = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    starts, lens = np.array([3000, 8000]), np.array([1280, 1280])
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = make_cnn_runner(Config(), CKPT, device=cuda_device)(audio, starts, lens).cpu().numpy()
        assert torch.backends.cudnn.allow_tf32  # the global switch is left as it was
    finally:
        torch.backends.cudnn.allow_tf32 = False
    want = make_cnn_runner(Config(), CKPT, device="cpu")(audio, starts, lens).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _backward_inputs(device, B, T, H):
    """Seeded xw, W_hh of both directions and the incoming gradient g on the
    card, and h, c written by lstm_fwd."""
    rng = np.random.default_rng(B + T)
    xw_f, xw_b = (rng.standard_normal((B, T, 4 * H)).astype(np.float32) for _ in range(2))
    w_f, w_b = ((rng.standard_normal((H, 4 * H)) * 0.1).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    xw_f, w_f, xw_b, w_b, g = _on_card(device, xw_f, w_f, xw_b, w_b, g)
    h, c = lstm_cell.bilstm_forward(xw_f, w_f, xw_b, w_b, with_c=True)
    return xw_f, w_f, xw_b, w_b, g, h, c


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H", [
    (25, 417, 128),  # the training shapes: 7 clusters of 8 CTAs a direction
    (5, 29, 16),  # B not a multiple of the 4 rows of a cluster; 2 units a CTA
    (1, 33, 128),  # B=1: a cluster with one live row
    (6, 1, 128),  # T=1: no carry, no h_prev
    (3, 11, 4),  # H=4: clusters of 4 CTAs, 1 unit each, one k-slice
    (7, 23, 12),  # H=12: 3 units a CTA (odd), 3 k-slices
    (128, 417, 128),  # the batch of cnn_blstm_formant_v2_b128_r4.npz: 64 clusters
])
def test_backward_kernels_match_plain_on_card(cuda_device, B, T, H):
    """lstm_bwd and lstm_dwhh against the plain backward of each direction,
    on h and c written by lstm_fwd, at shapes that reach the edges of the
    cluster layout and of the split-K reduction."""
    xw_f, w_f, xw_b, w_b, g, h, c = _backward_inputs(cuda_device, B, T, H)
    want_h = lstm_cell.bilstm_recurrence_reference(xw_f, w_f, xw_b, w_b, return_c=True)
    np.testing.assert_allclose(c.cpu().numpy(), want_h[1].cpu().numpy(), rtol=0, atol=1e-4)
    before = (_launches("lstm_bwd"), _launches("lstm_dwhh"))
    dxw_f, dxw_b = lstm_cell.bilstm_recurrence_backward(xw_f, w_f, xw_b, w_b, h, c, g)
    dw_f, dw_b = lstm_cell.bilstm_dwhh(h, dxw_f, dxw_b)
    torch.cuda.synchronize()
    assert (_launches("lstm_bwd"), _launches("lstm_dwhh")) == (
        before[0] + 1, before[1] + 1)
    for sl, xw, w, dxw, dw, reverse in ((slice(0, H), xw_f, w_f, dxw_f, dw_f, False),
                                        (slice(H, 2 * H), xw_b, w_b, dxw_b, dw_b, True)):
        want_dxw = lstm_cell.lstm_recurrence_backward_reference(
            xw, w, h[..., sl], c[..., sl], g[..., sl], reverse)
        want_dw = lstm_cell.dwhh_reference(h[..., sl], want_dxw, reverse)
        np.testing.assert_allclose(dxw.cpu().numpy(), want_dxw.cpu().numpy(), rtol=0, atol=1e-4)
        scale = want_dw.abs().max().item()
        np.testing.assert_allclose(dw.cpu().numpy(), want_dw.cpu().numpy(), rtol=0,
                                   atol=1e-4 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H", [(25, 417, 128), (5, 29, 16)])
def test_backward_kernels_are_deterministic(cuda_device, B, T, H):
    """Two launches on the same inputs give the same dxw and dW_hh, bit for bit."""
    xw_f, w_f, xw_b, w_b, g, h, c = _backward_inputs(cuda_device, B, T, H)
    runs = []
    for _ in range(2):
        dxw_f, dxw_b = lstm_cell.bilstm_recurrence_backward(xw_f, w_f, xw_b, w_b, h, c, g)
        runs.append((dxw_f, dxw_b, *lstm_cell.bilstm_dwhh(h, dxw_f, dxw_b)))
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


def _narrow_live_model(device, seed=0, freq_bins=65):
    """A narrow model with the JAX init's distributions, its BiLSTM weights
    then redrawn from U(-1/sqrt(rows), 1/sqrt(rows)): the JAX init's
    U[0, 2/sqrt(H)) saturates the gates and zeroes the BiLSTM's gradients."""
    model = StackedBLSTMCNN(num_lstm_layers=2, lstm_hidden_dim=16, freq_bins=freq_bins,
                            enc_filters=(4, 8), dec_filters=(4, 8))
    gen = torch.Generator().manual_seed(seed)
    model.init_weights(gen)
    with torch.no_grad():
        for name, p in model.lstm.named_parameters():
            if not name.endswith("_b"):
                bound = p.shape[0] ** -0.5
                p.copy_(torch.rand(p.shape, generator=gen) * 2 * bound - bound)
    return model.to(device).train()


@pytest.mark.gpu
def test_backward_on_card_reaches_every_parameter(cuda_device):
    """A loss through the model on the card gives every parameter a gradient
    (the BiLSTM's output carries its graph through lstm_fwd/lstm_bwd)."""
    model = _narrow_live_model(cuda_device)
    x = torch.randn(3, 65, 40, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    before = _launches("lstm_bwd")
    model(x).square().sum().backward()
    assert _launches("lstm_bwd") == before + 2  # one a layer
    missing = [n for n, p in model.named_parameters() if p.grad is None or not p.grad.any()]
    assert not missing, f"no gradient on the card: {missing}"


@pytest.mark.gpu
def test_training_step_on_card_matches_cpu(cuda_device):
    cfg = Config.from_dict({
        "data": {"max_len_s": 1.0, "gap_len_s": 0.1},
        "model": {"num_lstm_layers": 2, "lstm_hidden_dim": 16, "enc_filters": [4, 8],
                  "dec_filters": [4, 8]},
    })
    flat = cnn_blstm_flat_variables(_narrow_live_model("cpu", seed=2, freq_bins=257).state_dict())
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    starts = torch.tensor([[1000, 9000], [4000, 12000]])
    out = {}
    for device in (cuda_device, "cpu"):
        state = create_cnn_state(cfg, device=device, params=flat)
        _, m = make_cnn_train_step(cfg)(state, torch.tensor(audio, device=device),
                                        starts.to(device))
        out[str(device)] = (m["loss"].item(), {n: p.grad.cpu() for n, p in
                                               state.model.named_parameters()})
    (loss_d, g_d), (loss_c, g_c) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(loss_d, loss_c, rtol=1e-4)
    g_max = max(g.abs().max().item() for g in g_c.values())
    for name, want in g_c.items():
        noise = name.startswith(("enc_conv", "dec_conv0", "dec_conv1")) and name.endswith(".bias")
        scale = g_max if noise else want.abs().max().item()
        assert (g_d[name] - want).abs().max().item() <= 1e-3 * scale, name


def _gan_setup(width):
    """The GAN config at 1.5 s clips and its generator on the CPU: the tiny
    one of ``tests/test_inference.py`` with seeded random weights and
    BatchNorm statistics, or the default widths with ``gan_formant_v2_r2.npz``."""
    cfg = gan_config()
    cfg.data.max_len_s = 1.5
    if width == "default":
        return cfg, make_gan_runner(cfg, GAN_CKPT, device="cpu").generator
    cfg.model.generator.enc_layer_cfg = [(8, 7, 2), (16, 5, 2), (16, 3, 2)]
    cfg.model.generator.dec_layer_cfg = [(16, 3, 1), (8, 3, 1)]
    cfg.model.generator.final_interim_ch = 8
    gen = build_generator(cfg, device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, t in gen.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) * 1.5 + 0.5)
            elif t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=g) * 0.15)
    return cfg, gen


@pytest.mark.gpu
@pytest.mark.parametrize("width", ["tiny", "default"])
@pytest.mark.parametrize("mode,phase", [("enhanced", "oracle"), ("parity", "oracle"),
                                        ("enhanced", "impaired")])
def test_gan_serving_on_card_matches_cpu(cuda_device, width, mode, phase):
    cfg, gen = _gan_setup(width)
    audio = torch.tensor(synthetic_dataset_batch(2, 1.5))
    starts, lens = torch.tensor([8000, 20000]), torch.tensor([1280, 1300])
    want_r, want_g = make_gan_inpaint_fn(cfg, gen, mode=mode, phase=phase)(audio, starts, lens)
    card = copy.deepcopy(gen).to(cuda_device)
    got_r, got_g = make_gan_inpaint_fn(cfg, card, mode=mode, phase=phase)(
        audio.to(cuda_device), starts.to(cuda_device), lens.to(cuda_device))
    assert torch.isfinite(got_g).all()
    np.testing.assert_allclose(got_g.cpu().numpy(), want_g.numpy(), rtol=0, atol=2e-4)
    np.testing.assert_allclose(got_r.cpu().numpy(), want_r.numpy(), rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("width", ["tiny", "default"])
def test_gan_bf16_on_card_matches_cpu_bf16(cuda_device, width):
    """bf16 on the card against bf16 on the CPU: two libraries' bf16
    roundings (the CPU tests hold the port's bf16 to JAX's within 6e-2 on
    the generator's output and 1e-3 on the waveform)."""
    cfg, gen = _gan_setup(width)
    audio = torch.tensor(synthetic_dataset_batch(2, 1.5))
    starts, lens = torch.tensor([8000, 20000]), torch.tensor([1280, 1300])
    want_r, want_g = make_gan_inpaint_fn(cfg, gen, mode="enhanced",
                                         compute_dtype=torch.bfloat16)(audio, starts, lens)
    card = copy.deepcopy(gen).to(cuda_device)
    got_r, got_g = make_gan_inpaint_fn(cfg, card, mode="enhanced", compute_dtype=torch.bfloat16)(
        audio.to(cuda_device), starts.to(cuda_device), lens.to(cuda_device))
    assert torch.isfinite(got_g).all()
    np.testing.assert_allclose(got_g.cpu().numpy(), want_g.numpy(), rtol=0, atol=6e-2)
    np.testing.assert_allclose(got_r.cpu().numpy(), want_r.numpy(), rtol=0, atol=1e-3)


@pytest.mark.gpu
def test_gan_serving_runs_full_f32_under_global_tf32_defaults(cuda_device):
    """Under torch's own defaults (cuDNN convolutions in TF32) the f32 GAN
    runner gives what it gives with TF32 off, bit for bit, and matches the
    CPU: its convolutions run in full f32 whatever the global switch says."""
    cfg = gan_config()
    cfg.data.max_len_s = 1.5
    audio = synthetic_dataset_batch(2, 1.5)
    starts, lens = np.array([8000, 20000]), np.array([1280, 1300])
    runner = make_gan_runner(cfg, GAN_CKPT, device=cuda_device)
    off = runner(audio, starts, lens).cpu()
    torch.backends.cudnn.allow_tf32 = True
    try:
        on = runner(audio, starts, lens).cpu()
        assert torch.backends.cudnn.allow_tf32  # the global switch is left as it was
    finally:
        torch.backends.cudnn.allow_tf32 = False
    torch.testing.assert_close(on, off, rtol=0, atol=0)
    want = make_gan_runner(cfg, GAN_CKPT, device="cpu")(audio, starts, lens)
    np.testing.assert_allclose(on.numpy(), want.numpy(), rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_gan_runner_defaults_to_cuda(cuda_device):
    cfg = gan_config()
    cfg.data.max_len_s = 0.5
    runner = make_gan_runner(cfg, GAN_CKPT, transport_window=2048)
    assert next(runner.generator.parameters()).device.type == "cuda"
    patch, start = runner(synthetic_dataset_batch(1, 0.5), [2000], [1280])
    assert patch.device.type == start.device.type == "cuda"
    assert patch.dtype == torch.int16 and start.tolist() == [2000]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_gan_requests_are_bitwise_equal(cuda_device, dtype):
    """Two requests of the same batch give the same waveform and payload,
    bit for bit, in f32 and in bf16."""
    cfg = gan_config()
    audio = torch.tensor(synthetic_dataset_batch(4), device=cuda_device)
    starts = torch.full((4,), 32000, device=cuda_device)
    lens = torch.full((4,), 1280, device=cuda_device)
    runner = make_gan_runner(cfg, GAN_CKPT, device=cuda_device, compute_dtype=dtype,
                             transport_window=2048)
    first, again = runner.inpaint_fn(audio, starts, lens), runner.inpaint_fn(audio, starts, lens)
    torch.testing.assert_close(first[1], again[1], rtol=0, atol=0)  # the generator's output
    torch.testing.assert_close(first[0], again[0], rtol=0, atol=0)  # the waveform
    (p1, s1), (p2, s2) = runner(audio, starts, lens), runner(audio, starts, lens)
    assert torch.equal(p1, p2) and torch.equal(s1, s2)


# ---------------------------------------------------------------- bf16 forms


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each entry of ``t`` (2^-7 of its binade), as f32."""
    mag = t.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _assert_bf16_close(name, got, want, atol):
    """``got`` (bf16) within one bf16 ulp of ``want`` plus ``atol``."""
    assert got.dtype == torch.bfloat16, (name, got.dtype)
    err = (got.float() - want.float()).abs()
    bound = _bf16_ulp(want) + atol
    worst = (err - bound).max().item()
    assert worst <= 0, f"{name}: {int((err > bound).sum())} entries beyond one ulp + {atol}"


def _bf16(*tensors):
    return [t.to(torch.bfloat16) for t in tensors]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H", [
    (32, 417, 128),  # serving batch; 16 units a CTA: 16-byte xw copies
    (25, 417, 128),  # the f32 training batch
    (128, 417, 128),  # the production recipe's batch: 16 rows a cluster
    (130, 20, 128),  # 9 clusters of 16 rows, the last with 2 live rows
    (1, 33, 128),  # B=1: a cluster with one live row
    (5, 29, 16),  # 2 units a CTA: 4-byte xw copies, 4 k-tiles
    (3, 11, 4),  # 1 unit a CTA: xw element by element, 2 k-tiles
    (7, 23, 12),  # 3 units a CTA (odd): element by element
    (9, 31, 68),  # 17 units a CTA: 3 groups of 8, 6 k-tiles
    (3, 19, 124),  # 31 units a CTA: 4 groups of 8
    (6, 1, 128),  # T=1
])
def test_bf16_forward_kernel_matches_plain_on_card(cuda_device, B, T, H):
    """h and c of lstm_fwd in bf16 (the tensor-core kernel) against the
    plain version in bf16 (f32 carries, the product of FWD_PIECES bf16
    pieces of h, bf16 stores), both directions; h without c is the same
    launch bit for bit; the launch is counted as a bf16 one, and the f32
    plan's ``rows`` is refused in bf16."""
    layer = _bf16(*_forward_inputs(cuda_device, B, T, H))
    before = (_launches("lstm_fwd"), _launches("lstm_fwd", bf16_only=True))
    h, c = lstm_cell.bilstm_forward(*layer, with_c=True)
    torch.cuda.synchronize()
    assert (_launches("lstm_fwd"), _launches("lstm_fwd", bf16_only=True)) == (
        before[0] + 1, before[1] + 1)
    want_h, want_c = lstm_cell.bilstm_recurrence_reference(*layer, return_c=True)
    _assert_bf16_close("h", h, want_h, 1e-4)
    _assert_bf16_close("c", c, want_c, 1e-4)
    with pytest.raises(ValueError, match="batch rows a cluster"):
        lstm_cell.bilstm_forward(*layer, rows=lstm_cell.FWD_MMA_ROWS)
    h_only, none = lstm_cell.bilstm_forward(*layer)
    assert none is None and torch.equal(h_only, h)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H", [(128, 417, 128), (25, 417, 128), (7, 23, 12)])
def test_bf16_forward_kernel_is_deterministic(cuda_device, B, T, H):
    """Two bf16 launches on the same inputs give the same h and c, bit for bit."""
    layer = _bf16(*_forward_inputs(cuda_device, B, T, H))
    first = lstm_cell.bilstm_forward(*layer, with_c=True)
    second = lstm_cell.bilstm_forward(*layer, with_c=True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.gpu
@pytest.mark.parametrize("change", [
    {"rows": 4, "groups": 8},  # no such instance (8 x 4 rows cover B=32)
    {"rows": 16, "groups": 2},  # no such instance (2 x 16 rows cover B=32)
    {"cluster": 3},  # does not divide H
    {"cluster": 16},  # above the portable cluster size
    {"cluster": 1},  # 128 units a CTA: 16 tile pairs, 32 warps
    {"groups": 1},  # too few clusters for B=32
    {"groups": 5},  # more clusters than B=32 needs at 8 rows a cluster
])
def test_bf16_forward_launcher_refuses_a_plan_it_cannot_run(cuda_device, monkeypatch, change):
    """The bf16 launcher checks the plan it is given and launches nothing on
    one it cannot run; the wrapper raises with the plan in the message."""
    layer = _bf16(*_forward_inputs(cuda_device, 32, 5, 128))
    good = lstm_cell.fwd_mma_plan(32, 128)
    bad = dataclasses.replace(good, **change)
    monkeypatch.setattr(lstm_cell, "fwd_mma_plan", lambda b, hh: bad)
    before = _launches("lstm_fwd")
    with pytest.raises(RuntimeError, match=r"lstm_fwd launch failed with CUDA error 1 .*ClusterPlan"):
        lstm_cell.bilstm_forward(*layer)
    assert _launches("lstm_fwd") == before


def _bf16_backward_inputs(device, B, T, H):
    xw_f, w_f, xw_b, w_b, g, _, _ = _backward_inputs(device, B, T, H)
    layer = _bf16(xw_f, w_f, xw_b, w_b)
    (g,) = _bf16(g)
    h, c = lstm_cell.bilstm_forward(*layer, with_c=True)
    return (*layer, g, h, c)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H", [
    (25, 417, 128),
    (128, 417, 128),  # the production recipe's batch
    (5, 29, 16),
    (1, 33, 128),
    (6, 1, 128),
    (3, 11, 4),  # H=4: h staged 8 bytes a copy, one k-slice
    (7, 23, 12),  # H=12: 3 units a CTA
])
def test_bf16_backward_kernels_match_plain_on_card(cuda_device, B, T, H):
    """lstm_bwd in bf16 (the tensor-core sweep: bf16 dxw and its bf16
    residual lo) and lstm_dwhh in bf16 (f32 sums of h_prev^T dxw + h_prev^T
    lo, rounded once) against the plain backward of each direction in bf16
    (the same bf16 pieces in the dh carry), on h and c written by the bf16
    lstm_fwd."""
    xw_f, w_f, xw_b, w_b, g, h, c = _bf16_backward_inputs(cuda_device, B, T, H)
    counts = ("lstm_bwd", "lstm_dwhh")
    before = [(_launches(k), _launches(k, bf16_only=True)) for k in counts]
    dxw_f, dxw_b, lo_f, lo_b = lstm_cell.bilstm_recurrence_backward(
        xw_f, w_f, xw_b, w_b, h, c, g, dgates=True)
    dw_f, dw_b = lstm_cell.bilstm_dwhh(h, dxw_f, dxw_b, lo_f, lo_b)
    torch.cuda.synchronize()
    assert [(_launches(k), _launches(k, bf16_only=True)) for k in counts] == [
        (n + 1, m + 1) for n, m in before]
    assert lo_f.dtype == lo_b.dtype == torch.bfloat16
    for sl, xw, w, dxw, lo, dw, reverse in (
            (slice(0, H), xw_f, w_f, dxw_f, lo_f, dw_f, False),
            (slice(H, 2 * H), xw_b, w_b, dxw_b, lo_b, dw_b, True)):
        want_dxw, want_dg = lstm_cell.lstm_recurrence_backward_reference(
            xw, w, h[..., sl], c[..., sl], g[..., sl], reverse, return_dgates=True)
        _assert_bf16_close("dxw", dxw, want_dxw, 1e-4)
        np.testing.assert_allclose((dxw.float() + lo.float()).cpu().numpy(),
                                   want_dg.cpu().numpy(), rtol=0, atol=1e-4)
        want_dw = lstm_cell.dwhh_reference(h[..., sl], want_dxw, reverse,
                                           lo=lstm_cell.bf16_residual(want_dg, want_dxw))
        _assert_bf16_close("dW_hh", dw, want_dw, 1e-4 * want_dw.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H", [(128, 417, 128), (7, 23, 12)])
def test_bf16_backward_kernels_are_deterministic(cuda_device, B, T, H):
    """Two bf16 launches of lstm_bwd and lstm_dwhh on the same inputs give
    the same dxw, lo and dW_hh, bit for bit."""
    inputs = _bf16_backward_inputs(cuda_device, B, T, H)
    runs = []
    for _ in range(2):
        out = lstm_cell.bilstm_recurrence_backward(*inputs, dgates=True)
        runs.append((*out, *lstm_cell.bilstm_dwhh(inputs[5], *out)))
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


# sha256 (first 16 hex digits) of (h, c, h without c) of the f32 forward
# kernel on _forward_inputs, as bilstm_forward launches it, taken on an H100
# from the kernel as it was before the bf16 form got a kernel of its own.
F32_FORWARD_DIGESTS = {
    (32, 417, 128): "46f0303b5ad4e31a",
    (25, 417, 128): "e545eb537c22d5ee",
    (128, 417, 128): "0bfe5b08281b70c3",
    (5, 29, 16): "4e4867a4305f6b5d",
    (1, 33, 128): "06239890509ef462",
    (3, 11, 4): "35832c29f7ffb94d",
    (7, 23, 12): "d5089059f82c990c",
    (3, 19, 124): "7e92596fdc08ee3e",
}


def f32_forward_digest(device, B, T, H):
    xw_f, w_f, xw_b, w_b = _forward_inputs(device, B, T, H)
    h, c = lstm_cell.bilstm_forward(xw_f, w_f, xw_b, w_b, with_c=True)
    h_only, _ = lstm_cell.bilstm_forward(xw_f, w_f, xw_b, w_b)
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for t in (h, c, h_only):
        digest.update(t.cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H", list(F32_FORWARD_DIGESTS))
def test_f32_forward_kernel_is_unchanged_bit_for_bit(cuda_device, B, T, H):
    """The f32 lstm_fwd, launched as serving and the f32 step launch it,
    gives the outputs of the f32 kernel before the bf16 redesign, bit for
    bit (the bf16 form is a kernel of its own)."""
    assert f32_forward_digest(cuda_device, B, T, H) == F32_FORWARD_DIGESTS[(B, T, H)]


# sha256 (first 16 hex digits) of (dxw_fwd, dxw_bwd, dW_fwd, dW_bwd) of the
# f32 backward kernels on _f32_digest_inputs, taken on an H100 from the
# kernels as they were before the bf16 forms got kernels of their own.
F32_BACKWARD_DIGESTS = {
    (25, 417, 128): "62d9bc5de9c3c358",
    (5, 29, 16): "39cb12dd6aa7bd54",
    (7, 23, 12): "e5cb0e580ffbfe17",
    (128, 417, 128): "425e7c9e6655fdaa",
}


def _f32_digest_inputs(device, B, T, H):
    rng = np.random.default_rng(B * 1000 + H)
    mk = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=device)
    xw_f, xw_b = mk(B, T, 4 * H), mk(B, T, 4 * H)
    w_f, w_b = mk(H, 4 * H) * H ** -0.5, mk(H, 4 * H) * H ** -0.5
    h = torch.tanh(mk(B, T, 2 * H))
    c, g = mk(B, T, 2 * H), mk(B, T, 2 * H)
    return xw_f, w_f, xw_b, w_b, h, c, g


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H", list(F32_BACKWARD_DIGESTS))
def test_f32_backward_kernels_are_unchanged_bit_for_bit(cuda_device, B, T, H):
    """The f32 forms of lstm_bwd and lstm_dwhh, launched as the f32 step
    launches them, give the outputs of the f32 kernels before the bf16
    redesign, bit for bit (the bf16 forms are kernels of their own)."""
    inputs = _f32_digest_inputs(cuda_device, B, T, H)
    dxw = lstm_cell.bilstm_recurrence_backward(*inputs, dgates=True)
    assert dxw[2] is None and dxw[3] is None
    dw = lstm_cell.bilstm_dwhh(inputs[4], *dxw)
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for t in (*dxw[:2], *dw):
        digest.update(t.cpu().numpy().tobytes())
    assert digest.hexdigest()[:16] == F32_BACKWARD_DIGESTS[(B, T, H)]


@pytest.mark.gpu
def test_bf16_kernels_refuse_mixed_dtypes(cuda_device):
    """A bf16 layer whose other tensors are f32 (or the reverse) launches
    nothing and raises: there is no fallback."""
    xw_f, w_f, xw_b, w_b, g, h, c = _bf16_backward_inputs(cuda_device, 5, 29, 16)
    counts = lstm_cell.kernel_launches()
    with pytest.raises(TypeError, match="of one type"):
        lstm_cell.bilstm_forward(xw_f, w_f.float(), xw_b, w_b)
    with pytest.raises(TypeError, match="of one type"):
        lstm_cell.bilstm_forward(xw_f.float(), w_f, xw_b.float(), w_b)
    with pytest.raises(TypeError, match="of one type"):
        lstm_cell.bilstm_recurrence(xw_f.float(), w_f.float(), xw_b, w_b)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        lstm_cell.bilstm_recurrence_backward(xw_f, w_f, xw_b, w_b, h, c, g.float())
    zeros = torch.zeros(xw_f.shape, device=cuda_device)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        lstm_cell.bilstm_dwhh(h, zeros, zeros, zeros, zeros)
    with pytest.raises(ValueError, match="pairs"):
        lstm_cell.bilstm_dwhh(h, *_bf16(zeros, zeros))
    assert counts == lstm_cell.kernel_launches()


@pytest.mark.gpu
def test_bf16_training_step_on_card_runs_the_bf16_kernels(cuda_device):
    """A bf16 train step of a narrow model on the card launches every LSTM
    kernel in bf16 only (one a layer), gives every parameter an f32
    gradient, and its loss lies within bf16's rounding of the f32 step's."""
    cfg = Config.from_dict({
        "data": {"max_len_s": 1.2, "gap_len_s": 0.05, "train_n_gaps": 3},
        "model": {"num_lstm_layers": 2, "lstm_hidden_dim": 16, "enc_filters": [4, 8],
                  "dec_filters": [4, 8]},
    })
    flat = cnn_blstm_flat_variables(_narrow_live_model("cpu", seed=2, freq_bins=257).state_dict())
    rng = np.random.default_rng(3)
    audio = torch.tensor((rng.standard_normal((2, 19200)) * 0.1).astype(np.float32),
                         device=cuda_device)
    starts = torch.tensor([[[3000, 9000, 14000]], [[4200, 8400, 15000]]], device=cuda_device)
    lengths = torch.tensor([[[400, 800, 160]], [[700, 300, 500]]], device=cuda_device)
    losses = {}
    for dtype in (torch.bfloat16, torch.float32):
        state = create_cnn_state(cfg, device=cuda_device, params=flat)
        kernels = lstm_cell.KERNELS
        before = [(_launches(k), _launches(k, bf16_only=True)) for k in kernels]
        _, m = make_cnn_train_step(cfg, compute_dtype=dtype)(state, audio, starts, lengths)
        torch.cuda.synchronize()
        after = [(_launches(k), _launches(k, bf16_only=True)) for k in kernels]
        bf16 = 2 if dtype == torch.bfloat16 else 0
        assert after == [(n + 2, m + bf16) for n, m in before], (dtype, before, after)
        for name, p in state.model.named_parameters():
            assert p.dtype == p.grad.dtype == torch.float32, name
            assert p.grad.any(), name
        losses[dtype] = m["loss"].item()
    # bf16 against f32: 1.8e-2 on the CPU for this batch.
    np.testing.assert_allclose(losses[torch.bfloat16], losses[torch.float32], rtol=5e-2)


# ------------------------------------------------------- deployable serving
#
# Each function of deployable serving on the card against the same function
# on the CPU, same inputs and weights, TF32 off.  Outside the gaps every
# deployable regime returns the input's own samples, bit for bit, on the card
# too.  The phase ops on the unit circle within 4e-3: the extrapolated phase
# reaches |steps * dphi| of ~2.5e4 rad (62 frames at up to 402 rad a hop in
# the top bins), where an f32 ulp is 2e-3 rad, and the card divides by a
# constant as a product with its reciprocal, so princarg can wrap a turn
# elsewhere and that sum rounds another way (3e-4 seen).  Inside the gaps,
# the bounds of chip_smoke.py's serving_deployable phase, each a share of
# each clip's gap peak: the GAN under extrapolate within 2e-2 (4.7e-3 seen
# there), the CNN+BiLSTM within 5e-3 (1.4e-3 seen).  Griffin-Lim's waveform
# inside a gap is not a stable function of its inputs (a 1e-7 change of the
# clip moves it by 2.6e-3 of its peak after 4 iterations, 7e-2 after 64, on
# the CPU); these tests run 4 iterations, and hold its STFT magnitude over
# each gap's frames within 5e-2 in relative L2 norm (1.5e-2 seen at 64
# iterations) and its waveform within 1e-2 of the gap peak (4.3e-3 seen).
# Griffin-Lim on a consistent spectrogram from a given phase, 4 iterations,
# within 1e-5 on the waveform.

GAN_DEPLOYABLE_RTOL = 2e-2
CNN_DEPLOYABLE_RTOL = 5e-3
GL_SPEC_RTOL = 5e-2
GL4_RTOL = 1e-2


def _gapped_clips(n=2, seconds=1.0):
    from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch

    return torch.tensor(speech_like_batch(np.random.default_rng(31), n, seconds))


def _check_deployable(got, want, audio, inside, phase, rtol_of_peak):
    """Outside the gaps the input, bit for bit; inside, each row within
    ``rtol_of_peak`` of the CPU's gap peak under ``extrapolate``, and under
    ``griffinlim`` (4 iterations) the STFT magnitude (GAN hop) over the
    gaps' frames and each row within ``GL4_RTOL`` of its gap peak."""
    got, want, audio, inside = (t.cpu() for t in (got, want, audio, inside))
    assert torch.isfinite(got).all()
    assert torch.equal(got[~inside], audio[~inside])
    if phase == "griffinlim":
        from ml_audio_inpainting_torch.ops.gaps import frame_mask_from_sample_mask
        from ml_audio_inpainting_torch.ops.stft import stft

        g, w = (stft(x, 512, 128, 512).abs() for x in (got, want))
        mask = frame_mask_from_sample_mask((~inside).float(), *g.shape[-2:], 128) < 0.5
        assert (g - w)[mask].norm() <= GL_SPEC_RTOL * w[mask].norm()
        rtol_of_peak = GL4_RTOL
    for g, w, i in zip(got, want, inside):
        np.testing.assert_allclose(g[i].numpy(), w[i].numpy(), rtol=0,
                                   atol=rtol_of_peak * w[i].abs().max().item())


def _interval_inside(n, starts, lens):
    idx = torch.arange(n)
    return (idx >= starts[:, None]) & (idx < (starts + lens)[:, None])


@pytest.mark.gpu
def test_phase_ops_on_card_match_cpu(cuda_device):
    from ml_audio_inpainting_torch.ops.phase import extrapolate_phase, window_clear_frame_mask
    from ml_audio_inpainting_torch.ops.stft import stft

    audio = _gapped_clips(3)
    mask = torch.ones_like(audio)
    mask[0, :900], mask[1, 4000:12000], mask[2, 15000:] = 0, 0, 0
    spec = stft(audio * mask, 512, 128, 512)
    ph = torch.where(spec == 0, 0.0, spec.angle())
    trust = window_clear_frame_mask(mask, spec.shape[-1], 128, 512, 512)
    got_t = window_clear_frame_mask(mask.to(cuda_device), spec.shape[-1], 128, 512, 512)
    assert torch.equal(got_t.cpu(), trust)
    want = extrapolate_phase(ph, trust, 128, 512)
    got = extrapolate_phase(ph.to(cuda_device), got_t, 128, 512).cpu()
    assert (torch.polar(torch.ones_like(got), got) - torch.polar(torch.ones_like(want), want)
            ).abs().max() <= 4e-3


@pytest.mark.gpu
def test_griffinlim_and_mel_on_card_match_cpu(cuda_device):
    from ml_audio_inpainting_torch.ops.griffinlim import griffinlim
    from ml_audio_inpainting_torch.ops.mel import mel_spectrogram
    from ml_audio_inpainting_torch.ops.stft import stft

    audio = _gapped_clips()
    spec = stft(audio, 512, 128, 512)
    mag, ph = spec.abs(), spec.angle()
    kw = dict(n_iter=4, n_fft=512, hop_length=128, win_length=512, length=16000)
    want = griffinlim(mag, init="given", init_phase=ph, **kw)
    got = griffinlim(mag.to(cuda_device), init="given", init_phase=ph.to(cuda_device), **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-5)
    g = torch.Generator(device=cuda_device)
    a = griffinlim(mag.to(cuda_device), generator=g.manual_seed(3), **kw)
    b = griffinlim(mag.to(cuda_device), generator=g.manual_seed(3), **kw)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    want_m = mel_spectrogram(audio, 16000, 512, 128, 64)
    got_m = mel_spectrogram(audio.to(cuda_device), 16000, 512, 128, 64).cpu()
    np.testing.assert_allclose(got_m.numpy(), want_m.numpy(), rtol=0,
                               atol=1e-5 * want_m.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("width", ["tiny", "default"])
@pytest.mark.parametrize("phase", ["extrapolate", "griffinlim"])
def test_deployable_gan_on_card_matches_cpu(cuda_device, width, phase):
    """Interval-, mask-driven and shift-ensemble GAN functions; the bf16
    generator under ``extrapolate`` against bf16 on the CPU (1e-2 of the
    peak)."""
    from ml_audio_inpainting_torch.runtime.inference import (
        make_gan_inpaint_mask_fn,
        make_tta_shift_fn,
    )
    from ml_audio_inpainting_torch.ops.gaps import gap_mask

    cfg, gen = _gan_setup(width)
    audio = torch.tensor(synthetic_dataset_batch(2, 1.5))
    starts, lens = torch.tensor([0, 12000]), torch.tensor([1280, 8000])
    card_gen = copy.deepcopy(gen).to(cuda_device)
    on = [t.to(cuda_device) for t in (audio, starts, lens)]
    inside = _interval_inside(audio.shape[-1], starts, lens)
    for dtype in (None, torch.bfloat16) if phase == "extrapolate" else (None,):
        want = make_gan_inpaint_fn(cfg, gen, mode="enhanced", phase=phase, gl_iters=4,
                                   compute_dtype=dtype)(audio, starts, lens)
        got = make_gan_inpaint_fn(cfg, card_gen, mode="enhanced", phase=phase, gl_iters=4,
                                  compute_dtype=dtype)(*on)
        _check_deployable(got[0], want[0], audio, inside, phase,
                          GAN_DEPLOYABLE_RTOL if dtype is None else 1e-2)
    mask = gap_mask(audio.shape[-1], starts, lens)
    want = make_gan_inpaint_mask_fn(cfg, gen, phase=phase, gl_iters=4)(audio, mask)
    got = make_gan_inpaint_mask_fn(cfg, card_gen, phase=phase, gl_iters=4)(on[0],
                                                                           mask.to(cuda_device))
    _check_deployable(got[0], want[0], audio, inside, phase, GAN_DEPLOYABLE_RTOL)
    base = make_gan_inpaint_fn(cfg, gen, mode="enhanced", phase=phase, gl_iters=4)
    card_base = make_gan_inpaint_fn(cfg, card_gen, mode="enhanced", phase=phase, gl_iters=4)
    want = make_tta_shift_fn(base, 128, 4)(audio, starts, lens)
    got = make_tta_shift_fn(card_base, 128, 4)(*on)
    _check_deployable(got[0], want[0], audio, inside, phase, GAN_DEPLOYABLE_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["extrapolate", "griffinlim"])
def test_deployable_cnn_on_card_matches_cpu(cuda_device, phase):
    """The committed CNN+BiLSTM by interval and by mask: 3 ``lstm_fwd``
    launches a request on the card."""
    from ml_audio_inpainting_torch.ops.gaps import gap_mask
    from ml_audio_inpainting_torch.runtime.inference import make_cnn_inpaint_mask_fn

    audio = _gapped_clips()
    starts, lens = torch.tensor([0, 4000]), torch.tensor([1280, 8000])
    inside = _interval_inside(16000, starts, lens)
    cpu = make_cnn_runner(Config(), CKPT, device="cpu", phase=phase, gl_iters=4)
    card = make_cnn_runner(Config(), CKPT, device=cuda_device, phase=phase, gl_iters=4)
    before = _launches("lstm_fwd")
    got = card(audio, starts, lens)
    assert _launches("lstm_fwd") == before + 3
    _check_deployable(got, cpu(audio, starts, lens), audio, inside, phase, CNN_DEPLOYABLE_RTOL)
    mask = gap_mask(16000, starts, lens)
    want = make_cnn_inpaint_mask_fn(Config(), cpu.model, phase=phase, gl_iters=4)(audio, mask)
    got = make_cnn_inpaint_mask_fn(Config(), card.model, phase=phase, gl_iters=4)(
        audio.to(cuda_device), mask.to(cuda_device))
    _check_deployable(got[0], want[0], audio, inside, phase, CNN_DEPLOYABLE_RTOL)


@pytest.mark.gpu
def test_longform_on_card_matches_cpu(cuda_device):
    """Both long-form paths around the committed GAN under ``extrapolate``,
    with no host wait inside a pass; PCM16 patches within the waveform bound
    (in LSB) of the CPU's."""
    from ml_audio_inpainting_torch.runtime.longform import (
        longform_inpaint,
        longform_inpaint_centered,
    )

    cfg, gen = _gan_setup("default")
    audio = _gapped_clips(1, 6.0)[0]
    starts, lens = np.array([2000, 40000, 70000]), np.array([1280, 1000, 900])
    card = make_gan_inpaint_fn(cfg, copy.deepcopy(gen).to(cuda_device), mode="enhanced",
                               phase="extrapolate")
    cpu = make_gan_inpaint_fn(cfg, gen, mode="enhanced", phase="extrapolate")
    kw = dict(window=24000, hop=12000, batch_size=4)
    want = longform_inpaint(cpu, audio, starts, lens, **kw)
    audio_d = audio.to(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = longform_inpaint(card, audio_d, starts, lens, **kw)
        patches, pstarts = longform_inpaint_centered(card, audio_d, starts, lens, window=24000,
                                                     batch_size=2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    inside = _interval_inside(len(audio), torch.tensor(starts), torch.tensor(lens))
    _check_deployable(got[None], want[None], audio[None], inside.any(0)[None], "extrapolate",
                      GAN_DEPLOYABLE_RTOL)
    want_p, want_s = longform_inpaint_centered(cpu, audio, starts, lens, window=24000, batch_size=2)
    assert torch.equal(pstarts.cpu(), want_s)
    lsb = 1 + GAN_DEPLOYABLE_RTOL * want_p.abs().max().item()
    assert (patches.cpu().int() - want_p.int()).abs().max().item() <= lsb


# ------------------------------------------------------ evaluation path
#
# The quality metrics on the card against the same functions on the CPU, on
# 5 s clips: cuFFT and the card's reductions sum in another order.  The dB
# metrics within 1e-3 dB, PSM within 1e-5, the total NMR within 1e-3 dB and
# ODG within 1e-4 (the bounds that hold the port to JAX on the CPU).  PEAQ's
# band grouping runs in full f32 inside its own scope, so turning TF32 on
# globally leaves the ODG unchanged, bit for bit.


def _metric_clips(n=4, seconds=5.0):
    from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch

    rng = np.random.default_rng(41)
    ref = speech_like_batch(rng, n, seconds)
    est = ref + 0.03 * rng.standard_normal(ref.shape).astype(np.float32)
    gap = np.zeros_like(ref)
    gap[:, 32000:33280] = 1.0
    est[0] = np.where(gap[0] > 0, 0.5 * est[0], ref[0])
    return ref, est, gap


@pytest.mark.gpu
def test_metrics_on_card_match_cpu(cuda_device):
    from ml_audio_inpainting_torch.train import auditory, metrics, peaq

    ref, est, gap = _metric_clips()
    cpu = [torch.tensor(a) for a in (ref, est, gap)]
    card = [t.to(cuda_device) for t in cpu]
    for name, fn, atol, takes_gap in (
        ("gap_sdr", metrics.gap_sdr, 1e-3, True), ("snr", metrics.snr, 1e-3, False),
        ("lsd", metrics.log_spectral_distance, 1e-3, False),
        ("fwseg_snr", metrics.fwseg_snr, 1e-3, False), ("psm", auditory.psm_score, 1e-5, False),
        ("nmr", peaq.nmr_total, 1e-3, False), ("odg", peaq.odg_score, 1e-4, False),
    ):
        args = (lambda t: t if takes_gap else t[:2])
        want = fn(*args(cpu))
        got = fn(*args(card))
        assert got.device == card[0].device and got.shape == (4,), name
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.gpu
def test_odg_on_card_keeps_full_f32_under_global_tf32(cuda_device):
    from ml_audio_inpainting_torch.train import peaq

    ref, est, _ = _metric_clips(2)
    r, e = torch.tensor(ref, device=cuda_device), torch.tensor(est, device=cuda_device)
    want = peaq.nmr_total(r, e)
    matmul = torch.backends.cuda.matmul
    matmul.allow_tf32 = True
    try:
        got = peaq.nmr_total(r, e)
        assert matmul.allow_tf32  # the scope restores the caller's setting
    finally:
        matmul.allow_tf32 = False
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_codec_round_trip_on_the_cards_machine(cuda_device, tmp_path):
    """The codec builds there (``g++``) and a FLAC written from the card's
    tensors reads back with its MD5 verified, equal to the 16-bit
    quantisation of what was written, bit for bit."""
    from ml_audio_inpainting_torch.data import audio_io

    ref, _, _ = _metric_clips(2)
    audio_io.save_audio(torch.tensor(ref[0], device=cuda_device), tmp_path / "a.flac")
    audio_io.write_audio(tmp_path / "b.wav", ref.T, 16000)
    got, rate, md5_ok = audio_io.read_audio(tmp_path / "a.flac")
    assert (rate, md5_ok) == (16000, 1)
    written = ref[0] / np.abs(ref[0]).max()
    v = written.astype(np.float64) * 32768.0
    levels = np.clip(np.trunc(v + np.where(v >= 0, 0.5, -0.5)), -32768, 32767)
    np.testing.assert_array_equal(got[:, 0], (levels / 32768.0).astype(np.float32))
    wav, _, wav_md5 = audio_io.read_audio(tmp_path / "b.wav")
    assert wav.shape == (80000, 2) and wav_md5 == -1


# ------------------------------------------------------------ GAN training

def _tiny_gan_cfg(n_gaps=1):
    """``tests/test_gan.py::tiny_gan_config``'s sizes, built here (this file
    imports nothing of the JAX package)."""
    cfg = gan_config()
    cfg.data.max_len_s, cfg.data.gap_len_s, cfg.data.train_n_gaps = 1.0, 0.1, n_gaps
    cfg.model.generator.enc_layer_cfg = [(8, 7, 2), (16, 5, 2), (16, 3, 2)]
    cfg.model.generator.dec_layer_cfg = [(16, 3, 1), (8, 3, 1)]
    cfg.model.generator.final_interim_ch = 8
    cfg.model.discriminator.layer_cfg = [(8, 2), (16, 2)]
    cfg.training.lambda_vgg_perceptual = cfg.training.lambda_vgg_style = 0.0
    return cfg


def _gan_step_on(device, cfg, dtype=torch.float32, tape=None, replay=False, **kw):
    """One GAN step from seeded weights on ``device`` in ``dtype``: (metrics,
    gradients by name, the D state's u and sigma, G's running statistics).
    With a ``tape``, the step records its kinks' branches into it, or with
    ``replay`` takes them from it."""
    import contextlib

    from ml_audio_inpainting_torch.train.gan_trainer import create_gan_states, make_gan_train_step
    from ml_audio_inpainting_torch.train.recipe import gan_gap_layouts
    from ml_audio_inpainting_torch.utils.branch_tape import branch_tape

    g, d = create_gan_states(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    g.model.to(device=device, dtype=dtype)  # in place: the optimizers keep the parameters
    d.model.to(device=device, dtype=dtype)
    audio = torch.tensor(speech_like_batch(np.random.default_rng(3), 2)[:, :cfg.data.max_samples],
                         device=device, dtype=dtype)
    gaps = [t.to(device) for t in gan_gap_layouts(torch.Generator().manual_seed(4), cfg, 2)]
    with contextlib.nullcontext() if tape is None else branch_tape(tape, replay):
        g, d, m = make_gan_train_step(cfg, **kw)(g, d, audio, *gaps)
    grads = {f"g.{n}": p.grad.double().cpu() for n, p in g.model.named_parameters()}
    grads.update({f"d.{n}": p.grad.double().cpu() for n, p in d.model.named_parameters()})
    state = {f"d.{k}": v.double().cpu() for k, v in d.model.state_dict().items()
             if k.endswith((".u", ".sigma"))}
    state.update({f"g.{k}": v.double().cpu() for k, v in g.model.state_dict().items()
                  if k.endswith(("running_mean", "running_var"))})
    return {k: float(v) for k, v in m.items()}, grads, state


@pytest.mark.gpu
@pytest.mark.parametrize("n_gaps", [1, 4])
def test_gan_step_on_card_matches_cpu(cuda_device, n_gaps):
    """The f32 GAN step on the card (TF32 off) against the port's step in
    f64 on the CPU from the same weights and batch, the f64 step taking the
    card's branch at every LeakyReLU (``utils/branch_tape.py``): losses
    rtol 1e-4, each gradient within 1e-3 of its largest entry (the CNN
    step's bound), D's u and sigma and G's running statistics after the
    step within 1e-5.  Without the replay two LeakyReLU inputs within f32's
    rounding of 0 go the other way in f64, and one entry of a BatchNorm
    bias's gradient lies 1.0e-3 (1 gap) and 1.2e-3 (4 gaps) of the largest
    from f64 on an H100 (with it, within 8.4e-7); the port's f32 step on
    that machine's CPU lies as far with 4 gaps
    (``scripts/torch_gan_step_precision.py --tiny N``)."""
    cfg = _tiny_gan_cfg(n_gaps)
    tape = []
    m_d, g_d, s_d = _gan_step_on(cuda_device, cfg, tape=tape)
    m_c, g_c, s_c = _gan_step_on(torch.device("cpu"), cfg, torch.float64, tape=tape, replay=True)
    for k, v in m_c.items():
        assert abs(m_d[k] - v) <= 1e-4 * abs(v) + 1e-7, (k, m_d[k], v)
    for name, want in g_c.items():
        scale = want.abs().max().item()
        assert (g_d[name] - want).abs().max().item() <= 1e-3 * scale + 1e-12, name
    for name, want in s_c.items():
        assert (s_d[name] - want).abs().max().item() <= 1e-5, name


@pytest.mark.gpu
def test_gan_remat_equals_plain_on_card(cuda_device):
    """``remat`` recomputes G, D and VGG in the backward: on the card the
    same losses (rtol 1e-6), gradients (1e-5 of each tensor's largest entry:
    cuDNN may pick another algorithm for a recomputed convolution),
    spectral-norm state and running statistics (1e-6) as the plain step."""
    cfg = _tiny_gan_cfg(4)
    m_p, g_p, s_p = _gan_step_on(cuda_device, cfg)
    m_r, g_r, s_r = _gan_step_on(cuda_device, cfg, remat=True)
    for k, v in m_p.items():
        assert abs(m_r[k] - v) <= 1e-6 * abs(v) + 1e-9, k
    for name, want in g_p.items():
        assert (g_r[name] - want).abs().max().item() <= 1e-5 * want.abs().max().item() + 1e-12, name
    for name, want in s_p.items():
        assert (s_r[name] - want).abs().max().item() <= 1e-6, name


@pytest.mark.gpu
def test_device_corpus_feed_on_card_keeps_the_order(cuda_device):
    from ml_audio_inpainting_torch.data.pipeline import (
        batch_iterator,
        device_corpus_feed,
        prefetch_to_device,
    )

    class Items:
        def __len__(self):
            return 13

        def __getitem__(self, i):
            return np.arange(6, dtype=np.float32) + i

    want = list(batch_iterator(Items(), 4, seed=5, epochs=2))
    got = list(device_corpus_feed(Items(), 4, seed=5, epochs=2, device=cuda_device))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and np.array_equal(a.cpu().numpy(), b)
    moved = list(prefetch_to_device(iter(want), device=cuda_device))
    for a, b in zip(moved, want):
        assert a.device.type == "cuda" and np.array_equal(a.cpu().numpy(), b)


# The classical solvers: the same port code on the card and on the CPU, in f64
# within 1e-9 of the CPU's largest |sample| in the gaps (every sum in another
# order; measured 1e-12 between the port and JAX on the CPU), and with no host
# sync inside a solve.


def _classical_inputs(device, dtype, n=8000):
    sig = speech_like_batch(np.random.default_rng(17), 3, n / 16000).astype(np.float64)
    gs = np.array([3000, 100, 7900])
    gl = np.array([320, 320, 320])
    mask = np.ones_like(sig)
    for i, (s, l) in enumerate(zip(gs, gl)):
        mask[i, s : s + l] = 0.0
    return [torch.tensor(a, device=device, dtype=t) for a, t in
            ((sig * mask, dtype), (mask, dtype), (gs, torch.int64), (gl, torch.int64))]


def _classical_solvers():
    from ml_audio_inpainting_torch.classical.arinpaint import arinpaint
    from ml_audio_inpainting_torch.classical.basisopt import aspain_learned
    from ml_audio_inpainting_torch.classical.janssen import janssen_gapwise
    from ml_audio_inpainting_torch.classical.ola import segmentation_inpaint
    from ml_audio_inpainting_torch.classical.spain import spain_inpaint

    return {
        "arinpaint": lambda *a: arinpaint(*a, order=64, context=1024, max_gap=512),
        "janssen_dense": lambda *a: janssen_gapwise(*a, p=32, maxit=3, max_gap=512,
                                                    context=1024, solver="dense"),
        "janssen_banded": lambda *a: janssen_gapwise(*a, p=32, maxit=3, max_gap=512,
                                                     context=1024),
        "segmentation": lambda *a: segmentation_inpaint(*a, p=32, maxit=2, max_gap=512),
        "aspain": lambda *a: spain_inpaint(*a, algorithm="aspain", maxit=30, max_gap=512),
        "sspain_omp": lambda *a: spain_inpaint(*a, algorithm="sspain_omp", maxit=4,
                                               max_gap=512),
        "aspain_learned": lambda x, m, gs, gl: aspain_learned(
            x, m, torch.eye(257, dtype=torch.complex64, device=x.device), maxit=30, n_fft=512,
            hop_length=192, win_length=384),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["arinpaint", "janssen_dense", "janssen_banded",
                                    "segmentation", "aspain", "sspain_omp", "aspain_learned"])
def test_classical_solver_on_card_matches_cpu_f64(cuda_device, solver):
    fn = _classical_solvers()[solver]
    card_in = _classical_inputs(cuda_device, torch.float64)
    want = fn(*_classical_inputs("cpu", torch.float64))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn(*card_in)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.device.type == "cuda" and got.dtype == torch.float64
    gap = card_in[1].cpu() == 0
    got = got.cpu()
    assert (got[gap] - want[gap]).abs().max() <= 1e-9 * want[gap].abs().max()
    assert torch.equal(got[~gap], card_in[0].cpu()[~gap])


@pytest.mark.gpu
def test_classical_linalg_on_card_matches_cpu_f64(cuda_device):
    from ml_audio_inpainting_torch.ops import linalg

    x = torch.tensor(speech_like_batch(np.random.default_rng(3), 4, 0.25), dtype=torch.float64)
    for fn in (linalg.lpc, linalg.arburg):
        want = fn(x, 64)
        got = fn(x.to(cuda_device), 64).cpu()
        assert (got - want).abs().max() <= 1e-9 * want.abs().max()
    q, nb = 16, 3
    D = torch.eye(q, dtype=torch.float64).repeat(2, nb, 1, 1) * 4
    D[1, 1] = -D[1, 1]  # the second system's second block is indefinite
    E = torch.full((2, nb, q, q), 0.01, dtype=torch.float64)
    r = torch.ones(2, nb * q, dtype=torch.float64)
    want, want_ok = linalg.block_tridiag_cholesky_solve(D, E, r)
    got, ok = linalg.block_tridiag_cholesky_solve(*(t.to(cuda_device) for t in (D, E, r)))
    assert ok.cpu().tolist() == want_ok.tolist() == [True, False]
    assert (got.cpu() - want).abs().max() <= 1e-9 * want.abs().max()


@pytest.mark.gpu
def test_classical_cli_on_card_matches_cpu(cuda_device, tmp_path):
    from ml_audio_inpainting_torch.cli import inpaint
    from ml_audio_inpainting_torch.data.audio_io import read_audio

    common = ["--model", "arinpaint", "--ar-preset", "tuned", "--input",
              os.path.join(REPO, "results", "formant_corpus_samples")]
    inpaint.main([*common, "--output", str(tmp_path / "card")])
    inpaint.main([*common, "--output", str(tmp_path / "cpu"), "--device", "cpu"])
    for f in sorted((tmp_path / "cpu").glob("*.flac")):
        got, want = read_audio(tmp_path / "card" / f.name)[0], read_audio(f)[0]
        # f32 on both: one LSB outside the gap (the peak's rounding), and the
        # f32 Levinson of order 512 within 1e-3 of the gap's peak inside it.
        gap = slice(32000, 33280)
        outside = np.ones(len(want), bool)
        outside[gap] = False
        assert np.abs(got - want)[outside].max() <= 1.0001 / 32768
        assert np.abs(got - want)[gap].max() <= max(3 / 32768, 1e-3 * np.abs(want[gap]).max())


# The training CLI's slice: the phase-mode step, the global-pool forward and
# checkpoints of state on the card.  Bounds as the training step's above
# (loss 1e-4 relative, gradients 1e-3 of their largest entry); the
# global-pool forward within 1e-4 of its output's largest entry.

def _phase_cfg() -> Config:
    return Config.from_dict({
        "data": {"max_len_s": 1.0, "gap_len_s": 0.1},
        "model": {"in_channels": 2, "num_lstm_layers": 2, "lstm_hidden_dim": 16,
                  "enc_filters": [4, 8], "dec_filters": [4, 8]},
        "training": {"starter_learning_rate": 1e-3},
    })


@pytest.mark.gpu
@pytest.mark.parametrize("anchored", [False, True], ids=["plain", "anchored"])
def test_phase_mode_step_on_card_matches_cpu(cuda_device, anchored):
    """The anchored target's anchor is ill-conditioned on quiet bins, so the
    anchored step is held at 5e-2 of each gradient's largest entry
    (``chip_smoke.py``'s ``CLI_ANCHORED_GRAD_RTOL``)."""
    cfg = _phase_cfg()
    init = create_cnn_state(cfg, device="cpu", seed=2)
    flat = cnn_blstm_flat_variables(init.model.state_dict())
    audio = speech_like_batch(np.random.default_rng(3), 2, 1.0)
    starts = torch.tensor([[1000, 9000], [4000, 12000]])
    out = {}
    for device in (cuda_device, "cpu"):
        state = create_cnn_state(cfg, device=device, params=flat)
        _, m = make_cnn_train_step(cfg, phase_mode=True, phase_anchor=anchored)(
            state, torch.tensor(audio, device=device), starts.to(device))
        out[str(device)] = (m["loss"].item(), {n: p.grad.cpu() for n, p in
                                               state.model.named_parameters()})
    (loss_d, g_d), (loss_c, g_c) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(loss_d, loss_c, rtol=1e-4)
    g_max = max(g.abs().max().item() for g in g_c.values())
    rtol = 5e-2 if anchored else 1e-3
    for name, want in g_c.items():
        noise = name.startswith(("enc_conv", "dec_conv0", "dec_conv1")) and name.endswith(".bias")
        scale = g_max if noise else want.abs().max().item()
        assert (g_d[name] - want).abs().max().item() <= rtol * scale, name


@pytest.mark.gpu
def test_global_pool_forward_on_card_matches_cpu(cuda_device):
    from ml_audio_inpainting_torch.models.port_torch import (
        load_torch_cnn_blstm,
        seeded_reference_cnn_state_dict,
    )

    sd = seeded_reference_cnn_state_dict(4, hidden=64, global_pool=True)
    model_c, _ = load_torch_cnn_blstm(sd)
    model_d, _ = load_torch_cnn_blstm(sd, device=cuda_device)
    assert model_d.global_pool and model_d.lstm.hidden_dim == 64
    x = torch.tensor(np.random.default_rng(5).standard_normal((2, 257, 84)), dtype=torch.float32)
    before = _launches("lstm_fwd")
    with torch.no_grad():
        want = model_c(x)
        got = model_d(x.to(cuda_device)).cpu()
    assert _launches("lstm_fwd") - before == 3
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.gpu
def test_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    from ml_audio_inpainting_torch.train.checkpoints import CheckpointManager, state_tree

    cfg = _phase_cfg()
    state = create_cnn_state(cfg, device=cuda_device, ema=0.9, seed=1)
    step = make_cnn_train_step(cfg, ema=0.9, phase_mode=True)
    audio = torch.tensor(speech_like_batch(np.random.default_rng(6), 2, 1.0), device=cuda_device)
    starts = torch.tensor([[2000, 7000], [3000, 11000]], device=cuda_device)
    state, _ = step(state, audio, starts)
    CheckpointManager(tmp_path).save(1, state)
    fresh = create_cnn_state(cfg, device=cuda_device, ema=0.9, seed=7)
    CheckpointManager(tmp_path).restore(fresh)
    assert all(p.is_cuda for p in fresh.model.parameters())
    assert all(v.is_cuda for s in fresh.optimizer.state.values() for k, v in s.items()
               if k != "step")
    want, got = state_tree(state), state_tree(fresh)

    def equal(a, b):
        if torch.is_tensor(b):
            return torch.equal(a, b)
        if isinstance(b, dict):
            return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in b)
        if isinstance(b, (list, tuple)):
            return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
        return a == b

    assert equal(got, want)


# ------------------------------------------------------------ the gap refiner
#
# The refiner (committed GAN and head) on the card against the same function
# on the CPU, f32, TF32 off: outside the gap the input bit for bit, inside it
# within chip_smoke.py's GAN_DEPLOYABLE_RTOL of the gap's peak (the neural
# channel is the GAN under extrapolate, whose phase can wrap a turn
# elsewhere on the card; the AR channel's f32 Levinson rounds apart too).
# A fresh head returns the AR fill inside the gap, bit for bit.


@pytest.mark.gpu
def test_refiner_on_card_matches_cpu(cuda_device):
    from ml_audio_inpainting_torch.models.refiner import WaveRefiner
    from ml_audio_inpainting_torch.runtime.serve import load_generator
    from ml_audio_inpainting_torch.train import refiner_trainer as rt
    from ml_audio_inpainting_torch.weights import load_params_npz

    cfg = gan_config()
    head_npz = os.path.join(REPO, "results", "checkpoints", "refiner_formant_v2_r3.npz")
    audio = torch.tensor(synthetic_dataset_batch(2))
    gs, gl = torch.tensor([32000, 20000]), torch.tensor([1280, 2048])
    inside = torch.zeros(audio.shape, dtype=torch.bool)
    for i in range(2):
        inside[i, gs[i]:gs[i] + gl[i]] = True
    out = {}
    for dev in ("cpu", cuda_device):
        fn = rt.make_refiner_apply_fn(cfg, load_generator(cfg, GAN_CKPT, dev))
        head = rt.load_refiner(load_params_npz(head_npz), dev)
        out[str(dev)] = fn(head, audio.to(dev), gs.to(dev), gl.to(dev)).cpu()
        fresh = WaveRefiner().init_weights(torch.Generator().manual_seed(0)).to(dev)
        ex = rt.make_example_fn(cfg, load_generator(cfg, GAN_CKPT, dev))(
            audio.to(dev), gs.to(dev), gl.to(dev))
        with torch.no_grad():
            first = fresh(ex["impaired"], ex["ar"], ex["neural"], ex["gap_ind"])
        assert torch.equal(first, torch.where(ex["gap_ind"] > 0, ex["ar"], ex["impaired"]))
    _check_deployable(out["cuda"], out["cpu"], audio, inside, "extrapolate", GAN_DEPLOYABLE_RTOL)


# The corpus CLIs on the card: their gaps are drawn on the host, so the
# card's files are the CPU's (preprocess: a product by 0 or 1, bit for bit;
# build_gaps_table's cos^2 fades within one 16-bit LSB) and the tables equal.


@pytest.mark.gpu
def test_corpus_clis_on_card_match_cpu(cuda_device, tmp_path):
    from ml_audio_inpainting_torch.cli import build_gaps_table, preprocess
    from ml_audio_inpainting_torch.data.audio_io import read_audio, save_audio

    for i, clip in enumerate(speech_like_batch(np.random.default_rng(4), 6, 2.0)):
        save_audio(clip * 0.8, tmp_path / "tree" / f"d{i % 2}" / f"c{i}.flac", normalize=False)
    tables = {}
    for where, device in (("card", "cuda"), ("cpu", "cpu")):
        preprocess.main(["--input", str(tmp_path / "tree"), "--output", str(tmp_path / where),
                         "--max-len", "2.0", "--batch-size", "4", "--device", device])
        tables[where] = build_gaps_table.main([
            "--input", str(tmp_path / "tree"), "--output", str(tmp_path / f"{where}.json"),
            "--mode", "multi", "--n-gaps", "3", "--max-len", "2.0", "--write-audio",
            str(tmp_path / f"{where}_gapped"), "--device", device])
    assert tables["card"] == tables["cpu"]
    cpu_files = sorted((tmp_path / "cpu").rglob("*.flac"))
    assert len(cpu_files) == 6
    for f in cpu_files:
        card = read_audio(tmp_path / "card" / f.relative_to(tmp_path / "cpu"))[0]
        np.testing.assert_array_equal(card, read_audio(f)[0])
    for f in sorted((tmp_path / "cpu_gapped").glob("*.flac")):
        card = read_audio(tmp_path / "card_gapped" / f.name)[0]
        assert np.abs(card - read_audio(f)[0]).max() <= 1.0001 / 32768


# Multi-device: two ranks sharing the card (gloo; NCCL refuses two ranks on
# one device) take the 1 x 2 CNN+BiLSTM step, with layer 0's w_ih and the
# projection split over ``model``; the losses and parameters against the
# one-rank step on the card at tests/test_parallel.py's bounds (loss rtol
# 1e-5 f32 and 5e-3 bf16, parameters one Adam step: 2.1 lr), and each rank
# launches the step's three kernels 3 times (one a BiLSTM layer, hidden 16).

MP_CFG = {"data": {"max_len_s": 0.5, "gap_len_s": 0.05, "gaps_per_audio": 2,
                   "spectrogram": {"n_fft": 256, "hop_length": 64, "win_length": 256}},
          "model": {"num_lstm_layers": 3, "lstm_hidden_dim": 16, "enc_filters": [4, 8],
                    "dec_filters": [8, 8]},
          "training": {"starter_learning_rate": 1e-4}}


def _mp_step(device, mesh, flat, batch, dtype):
    from ml_audio_inpainting_torch.parallel.mesh import shard_batch
    from ml_audio_inpainting_torch.parallel.sharding import (
        gather_state,
        make_sharded_step,
        place_state,
    )

    cfg = Config.from_dict(MP_CFG)
    state = create_cnn_state(cfg, device=device, params=flat)
    step = make_sharded_step(make_cnn_train_step(cfg, compute_dtype=dtype), state, mesh)
    place_state(state, mesh)
    state, m = step(state, *shard_batch(batch, mesh))
    return m["loss"].item(), gather_state(state, mesh)["model"], sorted(state.shardings)


def model_parallel_rank(device, flat, batch):
    """One of two ranks on the card: the 1 x 2 step in f32 and in bf16."""
    from ml_audio_inpainting_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(1, 2, device=device)
    return {dtype: _mp_step(device, mesh, flat, batch, dtype)
            for dtype in (None, torch.bfloat16)}


@pytest.mark.gpu
def test_model_parallel_step_on_two_ranks_of_the_card(cuda_device):
    from ml_audio_inpainting_torch.parallel.launch import spawn
    from ml_audio_inpainting_torch.parallel.mesh import make_mesh

    from ml_audio_inpainting_torch.train.recipe import live_bilstm

    fresh = create_cnn_state(Config.from_dict(MP_CFG), device="cpu", seed=4).model.state_dict()
    flat = live_bilstm(cnn_blstm_flat_variables(fresh), seed=5)
    rng = np.random.default_rng(5)
    batch = ((rng.standard_normal((2, 8000)) * 0.1).astype(np.float32),
             np.array([[500, 4000], [2000, 6000]]))
    ranks = spawn(model_parallel_rank, 2, "cuda", flat, batch, timeout_s=600)
    one = {dtype: _mp_step(cuda_device, make_mesh(device=cuda_device), flat, batch, dtype)
           for dtype in (None, torch.bfloat16)}
    for dtype, rtol in ((None, 1e-5), (torch.bfloat16, 5e-3)):
        loss, model, split = ranks[0].value[dtype]
        assert split == ["lstm.l0_bwd_w_ih", "lstm.l0_fwd_w_ih", "projection.weight"]
        assert ranks[1].value[dtype][0] == loss
        np.testing.assert_allclose(loss, one[dtype][0], rtol=rtol)
        for name, want in one[dtype][1].items():
            if want.is_floating_point() and not name.endswith(("running_mean", "running_var")):
                assert (model[name] - want).abs().max().item() <= 2.1e-4, name
    for r in ranks:
        assert r.kernel_launches == {**{k: 3 for k in lstm_cell.KERNELS},
                                     **{f"{k}_bf16": 3 for k in lstm_cell.KERNELS}}, \
            r.kernel_launches


def _traced_roots(fn, units: int):
    """``fn()`` ``units`` times under a CPU and CUDA profiler, after one warm
    call: the program's spans of that stretch, by root."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities):
        for _ in range(units):
            fn()
        torch.cuda.synchronize()
    records = profiling.stretch()
    roots = [r for r in records if r.parent is None]
    return [(root, [r for r in records if r.unit == root.unit and r is not root])
            for root in roots]


def _unit(path: str, device):
    """(one request or step of ``path`` as a call, its root span's name)."""
    audio = torch.tensor(speech_like_batch(np.random.default_rng(7), 32), device=device)
    if path == "cnn_serve_b32":
        runner = make_cnn_runner(Config(), CKPT, device=device, phase="extrapolate")
        fn = make_gap_transport_fn(runner.inpaint_fn, DEFAULT_PATCH_WINDOW)
        starts = torch.full((32,), GAP_START, device=device)
        lens = torch.full((32,), GAP_LEN, device=device)
        return lambda: fn(audio, starts, lens), "serve.request"
    cfg = Config.from_dict({"training": {"batch_size": 32}})
    state = create_cnn_state(cfg, device=device)
    step = make_cnn_train_step(cfg, compute_dtype=torch.bfloat16)
    starts = torch.full((32, 1), GAP_START, device=device)
    return lambda: step(state, audio, starts), "train.step"


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["cnn_serve_b32", "cnn_train_b32"])
def test_span_device_times_add_up_to_their_root(cuda_device, path):
    """Each span of a request or step carries CUDA events whose device time
    is positive, and its children's times add up to within 5 % of the
    root's.  Each stage ends where the next one opens, so this shows the
    prologue before the first stage is small; that no kernel is launched
    between two stages is the next test's."""
    call, root_name = _unit(path, cuda_device)
    units = _traced_roots(call, 3)
    assert [root.name for root, _ in units] == [root_name] * 3
    for root, children in units:
        assert len(children) >= 4
        assert all(r.device_ms > 0 for r in (root, *children))
        total = sum(r.device_ms for r in children)
        assert abs(total - root.device_ms) <= 0.05 * root.device_ms, (
            [(r.name, r.device_ms) for r in children], root.device_ms)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["cnn_serve_b32", "cnn_train_b32"])
def test_every_kernel_of_a_unit_is_launched_in_a_stage(cuda_device, path):
    """Every op that launches kernels under a request's or step's root span,
    after its first stage opened, runs in one of its stages (the profiler's
    own CPU-op tree and kernel links): no stage's device time holds kernels
    launched between two stages.  The backward's kernels, launched from the
    autograd engine's thread, sit inside ``train.backward``'s call."""
    from torch.autograd import DeviceType

    call, root_name = _unit(path, cuda_device)
    call()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(2):
            call()
        torch.cuda.synchronize()
    events = prof.events()

    def launches(e):
        return e.device_type == DeviceType.CPU and bool(e.kernels)

    def under_root(e):
        while e is not None and e.name != root_name:
            e = e.cpu_parent
        return e is not None

    assert sum(under_root(e) for e in events if launches(e)) > 10
    assert outside_stages(events, root_name, launches) == []


class _ItemInBackward(torch.autograd.Function):
    """The identity, whose backward reads a value to the host."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g.sum().item()
        return g


@pytest.mark.gpu
def test_host_syncs_in_a_root_are_counted_also_in_backward(cuda_device):
    """Two ``.item()`` calls inside a live root, one of them in the autograd
    engine's thread during ``backward``, count 2 ``host_syncs``; the sync
    debug mode is restored after, and outside a root nothing counts."""
    x = torch.ones(64, device=cuda_device, requires_grad=True)
    profiling.span("idle")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        with profiling.span("test.root"):
            y = _ItemInBackward.apply(x).square().sum()
            y.item()
            y.backward()
        y.item()
    (root,) = profiling.stretch()
    assert root.counts.get("host_syncs") == 2, root.counts
    assert torch.cuda.get_sync_debug_mode() == 0
    assert root.device_ms > 0

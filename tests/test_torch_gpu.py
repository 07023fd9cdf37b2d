"""Tests of the port that need a CUDA card and ``nvcc``; each skips without a
card.  This file imports neither JAX nor ``tests/conftest.py``'s fixtures, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: the forward kernel against its plain version, ``atol=1e-4``
(f32 dots over H in the kernel's sequential order against cuBLAS', through
up to 417 steps).  The backward kernel's ``dxw``, ``atol=1e-4`` (the same,
over the reverse sweep); the dW_hh reduction, within 1e-4 of the largest
entry of dW_hh (a sum over B*T terms in another order).  Two launches of the
backward kernels on the same inputs agree bit for bit (no atomics, fixed
summation orders).  The serving path on the card against the same path on
the CPU, ``atol=1e-4`` on waveforms of peak 1 (every sum in another order;
TF32 off, and also with torch's global TF32 defaults, which the serving
entry point overrides for its convolutions).  A training step on the card
against the CPU: the loss to 1e-4 relative and each gradient within 1e-3 of
its largest entry (conv biases in front of BatchNorm, whose exact gradient is
zero, within 1e-3 of the model's largest gradient entry).
"""

import os

import numpy as np
import pytest
import torch

from ml_audio_inpainting_torch.models.cnn_blstm import StackedBLSTMCNN
from ml_audio_inpainting_torch.ops.cuda import lstm_cell
from ml_audio_inpainting_torch.runtime.serve import make_cnn_runner
from ml_audio_inpainting_torch.train.cnn_trainer import create_cnn_state, make_cnn_train_step
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.weights import cnn_blstm_flat_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "results", "checkpoints", "cnn_blstm_formant_v2_r2.npz")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; on one: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _on_card(device, *arrays):
    return [torch.tensor(a, device=device) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H", [(32, 417, 128), (5, 29, 16)])
def test_kernel_matches_plain_on_card(cuda_device, B, T, H):
    """The serving shapes, and a batch that is not a multiple of the
    kernel's 4 rows a block with H=16 (64 threads): each half of the output
    against the plain version of its direction."""
    rng = np.random.default_rng(B)
    xw_f, xw_b = (rng.standard_normal((B, T, 4 * H)).astype(np.float32) for _ in range(2))
    w_f, w_b = ((rng.standard_normal((H, 4 * H)) * 0.1).astype(np.float32) for _ in range(2))
    xw_f, w_f, xw_b, w_b = _on_card(cuda_device, xw_f, w_f, xw_b, w_b)
    before = lstm_cell.bilstm_recurrence.launches
    got = lstm_cell.bilstm_recurrence(xw_f, w_f, xw_b, w_b)
    torch.cuda.synchronize()
    assert lstm_cell.bilstm_recurrence.launches == before + 1
    assert got.shape == (B, T, 2 * H)
    for half, (xw, w, reverse) in zip((got[..., :H], got[..., H:]),
                                      ((xw_f, w_f, False), (xw_b, w_b, True))):
        want = lstm_cell.lstm_recurrence_reference(xw, w, reverse)
        np.testing.assert_allclose(half.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=1e-4)


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
    before = lstm_cell.bilstm_recurrence.launches
    got = card(audio, starts, lens).cpu().numpy()
    assert lstm_cell.bilstm_recurrence.launches == before + 3  # one a layer
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
    before = (lstm_cell.bilstm_recurrence_backward.launches, lstm_cell.bilstm_dwhh.launches)
    dxw_f, dxw_b = lstm_cell.bilstm_recurrence_backward(xw_f, w_f, xw_b, w_b, h, c, g)
    dw_f, dw_b = lstm_cell.bilstm_dwhh(h, dxw_f, dxw_b)
    torch.cuda.synchronize()
    assert (lstm_cell.bilstm_recurrence_backward.launches, lstm_cell.bilstm_dwhh.launches) == (
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
    before = lstm_cell.bilstm_recurrence_backward.launches
    model(x).square().sum().backward()
    assert lstm_cell.bilstm_recurrence_backward.launches == before + 2  # one a layer
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

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
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from ml_audio_inpainting_torch.models.build import build_generator
from ml_audio_inpainting_torch.models.cnn_blstm import StackedBLSTMCNN
from ml_audio_inpainting_torch.ops.cuda import lstm_cell
from ml_audio_inpainting_torch.runtime.inference import make_gan_inpaint_fn
from ml_audio_inpainting_torch.runtime.serve import make_cnn_runner, make_gan_runner
from ml_audio_inpainting_torch.runtime.synthetic import gan_config, synthetic_dataset_batch
from ml_audio_inpainting_torch.train.cnn_trainer import create_cnn_state, make_cnn_train_step
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.weights import cnn_blstm_flat_variables

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
    before = lstm_cell.bilstm_recurrence.launches
    h, c = lstm_cell.bilstm_forward(xw_f, w_f, xw_b, w_b, with_c=True)
    got = lstm_cell.bilstm_recurrence(xw_f, w_f, xw_b, w_b)
    torch.cuda.synchronize()
    assert lstm_cell.bilstm_recurrence.launches == before + 2
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
    before = lstm_cell.bilstm_recurrence.launches
    with pytest.raises(RuntimeError, match=r"lstm_fwd launch failed with CUDA error 1 .*ClusterPlan"):
        lstm_cell.bilstm_forward(xw_f, w_f, xw_b, w_b)
    assert lstm_cell.bilstm_recurrence.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("H", [4, 12, 16, 100, 124, 128])
def test_forward_plan_shared_memory_matches_the_source(cuda_device, H):
    """The Python mirror of FwdLayout gives the bytes the launcher asks for."""
    smem = lstm_cell.load_library("lstm_fwd").cdll.lstm_fwd_smem_bytes
    for rows in lstm_cell.FWD_ROW_CHOICES:
        plan = lstm_cell.fwd_plan(32, H, rows)
        assert smem(H, rows, plan.cluster, plan.ksplit) == lstm_cell.fwd_smem_bytes(plan)


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

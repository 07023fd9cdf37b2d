"""Tests of the port that need a CUDA card and ``nvcc``; each skips without a
card.  This file imports neither JAX nor ``tests/conftest.py``'s fixtures, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: the kernel against its plain version, ``atol=1e-4`` (f32 dots
over H in the kernel's sequential order against cuBLAS', through up to 417
steps).  The serving path on
the card against the same path on the CPU, ``atol=1e-4`` on waveforms of
peak 1 (every sum in another order; TF32 off).
"""

import os

import numpy as np
import pytest
import torch

from ml_audio_inpainting_torch.ops.cuda import lstm_cell
from ml_audio_inpainting_torch.runtime.serve import make_cnn_runner
from ml_audio_inpainting_torch.utils.config import Config

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

"""The port's LSTM recurrence (``ml_audio_inpainting_torch/ops/cuda/lstm_cell.py``)
against the JAX package's Pallas kernel (interpret mode on the CPU, as
``tests/test_extras.py`` runs it) and ``lstm_scan``.

On the CPU the wrapper takes the plain version; the CUDA kernel itself runs
in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.  Tolerance ``atol=1e-5``:
f32 dots over H=16 summed in other orders, through 29 steps of bounded
activations.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.ops.lstm import lstm_scan
from ml_audio_inpainting_tpu.ops.pallas.lstm_cell import lstm_recurrence_pallas
from ml_audio_inpainting_torch.ops.cuda import lstm_cell
from torch_threads import one_thread  # noqa: F401  (a module fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(B, T, H, seed):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((B, T, 4 * H)).astype(np.float32)
    w_hh = (rng.standard_normal((H, 4 * H)) * 0.1).astype(np.float32)
    return xw, w_hh


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_matches_pallas_and_scan(reverse):
    B, T, H = 3, 29, 16
    xw, w_hh = _inputs(B, T, H, seed=0)
    pallas = np.asarray(lstm_recurrence_pallas(jnp.asarray(xw), jnp.asarray(w_hh), reverse))
    z = jnp.zeros((B, H), jnp.float32)
    scan = np.asarray(lstm_scan(jnp.asarray(xw), jnp.asarray(w_hh), z, z, reverse=reverse))
    plain = lstm_cell.lstm_recurrence_reference(torch.tensor(xw), torch.tensor(w_hh), reverse)
    assert plain.shape == (B, T, H)
    np.testing.assert_allclose(plain.numpy(), pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(plain.numpy(), scan, rtol=0, atol=1e-5)


def test_cpu_wrapper_matches_pallas():
    """The wrapper on CPU tensors: forward h, then the reverse sweep's h."""
    B, T, H = 3, 29, 16
    xw_f, w_f = _inputs(B, T, H, seed=1)
    xw_b, w_b = _inputs(B, T, H, seed=2)
    want = np.concatenate(
        [
            np.asarray(lstm_recurrence_pallas(jnp.asarray(xw_f), jnp.asarray(w_f), False)),
            np.asarray(lstm_recurrence_pallas(jnp.asarray(xw_b), jnp.asarray(w_b), True)),
        ],
        axis=-1,
    )
    before = lstm_cell.kernel_launches()
    got = lstm_cell.bilstm_recurrence(*(torch.tensor(a) for a in (xw_f, w_f, xw_b, w_b)))
    assert lstm_cell.kernel_launches() == before  # CPU: no kernel launch
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,T,H", [(1, 1, 4), (5, 7, 8), (2, 40, 32)])
def test_plain_matches_scan_shapes(B, T, H):
    xw, w_hh = _inputs(B, T, H, seed=B * 100 + T)
    z = jnp.zeros((B, H), jnp.float32)
    for reverse in (False, True):
        want = np.asarray(lstm_scan(jnp.asarray(xw), jnp.asarray(w_hh), z, z, reverse=reverse))
        got = lstm_cell.lstm_recurrence_reference(torch.tensor(xw), torch.tensor(w_hh), reverse)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_wrapper_refuses_devices_it_has_no_kernel_for():
    xw = torch.zeros((2, 3, 16), device="meta")
    w_hh = torch.zeros((4, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        lstm_cell.bilstm_recurrence(xw, w_hh, xw, w_hh)
    with pytest.raises(ValueError, match="CUDA"):  # one direction on the CPU, one not
        lstm_cell.bilstm_recurrence(torch.zeros((2, 3, 16)), torch.zeros((4, 16)), xw, w_hh)


def _fake_nvcc(bin_dir, body):
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body + "\n")
    nvcc.chmod(0o755)


def test_import_does_not_invoke_nvcc(tmp_path):
    marker = tmp_path / "nvcc_was_called"
    _fake_nvcc(tmp_path / "bin", f"touch {marker}\nexit 1")
    env = dict(os.environ, PATH=f"{tmp_path / 'bin'}:{os.environ['PATH']}")
    code = textwrap.dedent(
        """
        import ml_audio_inpainting_torch.ops.cuda.lstm_cell
        import ml_audio_inpainting_torch.ops.lstm
        import ml_audio_inpainting_torch.runtime.serve
        import ml_audio_inpainting_torch.train.cnn_trainer
        """
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)
    assert not marker.exists()


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path / "bin", "echo 'lstm_fwd.cu(1): error: fake compiler message' >&2\nexit 2")
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}:{os.environ['PATH']}")
    monkeypatch.setattr(lstm_cell, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fake compiler message"):
        lstm_cell.load_library.__wrapped__("lstm_fwd")
    assert not list((tmp_path / "build").glob("*.so"))

"""The port's LSTM backward (``ml_audio_inpainting_torch/ops/cuda/lstm_cell.py``:
the plain version of ``lstm_bwd`` + ``lstm_dwhh`` and the autograd Function
``bilstm_recurrence``) against the JAX package.

* The plain backward (``lstm_recurrence_backward_reference`` for ``dxw``,
  ``dwhh_reference`` for ``dW_hh``) against the Pallas ``_bwd_kernel``
  (interpret mode on the CPU, through the ``custom_vjp``'s own
  ``_fwd``/``_bwd``) on the same saved ``h``, ``c`` and incoming gradient,
  for each direction.
* ``dxw`` **and** ``dW_hh`` of the Function against ``jax.grad`` of
  ``lstm_scan`` with respect to both (``tests/test_extras.py`` pins ``dxw``
  of the Pallas path only).
* ``torch.autograd.gradcheck`` of the CPU Function in f64.

Tolerance ``atol=1e-5`` in f32 (gradients of order 1, dots over H=16 and
sums over B*T=87 terms in other orders, through 29 steps).  The CUDA kernels
run in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.ops.lstm import lstm_scan
from ml_audio_inpainting_tpu.ops.pallas import lstm_cell as pallas_cell
from ml_audio_inpainting_torch.ops.cuda import lstm_cell
from ml_audio_inpainting_torch.ops.lstm import BiLSTM

B, T, H = 3, 29, 16
ATOL = 1e-5


def _inputs(seed):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((B, T, 4 * H)).astype(np.float32)
    w_hh = (rng.standard_normal((H, 4 * H)) * 0.1).astype(np.float32)
    g = rng.standard_normal((B, T, H)).astype(np.float32)
    return xw, w_hh, g


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_backward_matches_pallas_kernel(reverse):
    """Pallas keeps time-major (and, for the reverse direction, time-flipped)
    h and c; the port reads the same values batch-major in input time order."""
    xw, w_hh, g = _inputs(seed=int(reverse))
    _, residuals = pallas_cell._fwd(jnp.asarray(xw), jnp.asarray(w_hh), reverse)
    want_dxw, want_dw = pallas_cell._bwd(reverse, residuals, jnp.asarray(g))
    h_seq, c_seq = residuals[2:]

    def batch_major(seq):
        seq = np.swapaxes(np.asarray(seq), 0, 1)
        return seq[:, ::-1].copy() if reverse else seq

    h, c = batch_major(h_seq), batch_major(c_seq)
    got_dxw = lstm_cell.lstm_recurrence_backward_reference(
        *(torch.tensor(a) for a in (xw, w_hh, h, c, g)), reverse=reverse)
    got_dw = lstm_cell.dwhh_reference(torch.tensor(h), got_dxw, reverse)
    np.testing.assert_allclose(got_dxw.numpy(), np.asarray(want_dxw), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw), rtol=0, atol=ATOL)


def test_function_gradients_match_jax_grad_of_lstm_scan():
    """Both directions through one ``bilstm_recurrence``; the loss weighs the
    ``(B, T, 2H)`` output with fixed random numbers so every step's incoming
    gradient differs."""
    xw_f, w_f, _ = _inputs(seed=2)
    xw_b, w_b, _ = _inputs(seed=3)
    weight = np.random.default_rng(4).standard_normal((B, T, 2 * H)).astype(np.float32)
    z = jnp.zeros((B, H), jnp.float32)

    def jax_loss(xw_f, w_f, xw_b, w_b):
        out = jnp.concatenate([lstm_scan(xw_f, w_f, z, z, reverse=False),
                               lstm_scan(xw_b, w_b, z, z, reverse=True)], axis=-1)
        return jnp.sum(out * weight)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (xw_f, w_f, xw_b, w_b)))
    args = [torch.tensor(a, requires_grad=True) for a in (xw_f, w_f, xw_b, w_b)]
    out = lstm_cell.bilstm_recurrence(*args)
    (out * torch.tensor(weight)).sum().backward()
    for name, arg, w in zip(("dxw_fwd", "dW_hh_fwd", "dxw_bwd", "dW_hh_bwd"), args, want):
        np.testing.assert_allclose(arg.grad.numpy(), np.asarray(w), rtol=0, atol=ATOL,
                                   err_msg=name)


def test_gradcheck_of_cpu_function_in_f64():
    rng = np.random.default_rng(5)
    b, t, h = 2, 5, 4
    args = [
        torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float64, requires_grad=True)
        for shape, scale in (((b, t, 4 * h), 1.0), ((h, 4 * h), 0.3)) * 2
    ]
    assert torch.autograd.gradcheck(lstm_cell.bilstm_recurrence, args, eps=1e-6, atol=1e-7)


def test_bilstm_keeps_c_only_when_a_gradient_is_needed(monkeypatch):
    """Serving (``torch.inference_mode``, ``no_grad``) never asks the forward
    for ``c``; a forward under grad with trainable weights does."""
    calls = []
    plain = lstm_cell.bilstm_recurrence_reference

    def spy(*args, return_c=False):
        calls.append(return_c)
        return plain(*args, return_c=return_c)

    monkeypatch.setattr(lstm_cell, "bilstm_recurrence_reference", spy)
    model = BiLSTM(8, 4, num_layers=2)
    model.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        served = model(x)
    with torch.no_grad():
        model(x)
    assert calls == [False] * 4 and served.grad_fn is None
    calls.clear()
    trained = model(x)
    assert calls == [True, True] and trained.grad_fn is not None
    torch.testing.assert_close(trained.detach(), served, rtol=0, atol=0)


def test_backward_wrappers_refuse_devices_they_have_no_kernel_for():
    xw = torch.zeros((2, 3, 16), device="meta")
    w_hh = torch.zeros((4, 16), device="meta")
    h = torch.zeros((2, 3, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        lstm_cell.bilstm_recurrence_backward(xw, w_hh, xw, w_hh, h, h, h)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_cell.bilstm_dwhh(h, xw, xw)


def test_failed_backward_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """``lstm_bwd.cu`` goes through the same one-``nvcc``-call build as the
    forward source: a failed compile raises with the compiler's output and
    leaves no library behind."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'lstm_bwd.cu(7): error: fake compiler message' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    monkeypatch.setattr(lstm_cell, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="lstm_bwd.cu.*fake compiler message"):
        lstm_cell.load_library.__wrapped__("lstm_bwd")
    assert not list((tmp_path / "build").glob("*.so"))

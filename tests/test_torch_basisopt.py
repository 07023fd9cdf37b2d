"""The port's ``classical/basisopt.py`` against the JAX package's on the CPU:
the column hard threshold (with ties), A-SPAIN and S-SPAIN over learned-basis
STFT coefficients on a basis drawn from a seed (no learned basis is
committed), and ``optimize_basis`` for a few steps.

JAX runs the learned solvers in f32 only (their loop starts its best
objective as an f32 infinity, which ``lax.scan`` refuses to carry as f64),
so the parity bounds are f32:

* the learned solvers: 1e-5 of the gap's peak (measured 1e-7);
* ``optimize_basis``: the sparsities within 1e-4 relative and the basis
  within 2e-3 (measured 4.8e-4).  The gradients agree to 1e-7 relative and
  the matrix exponentials (``torch.linalg.matrix_exp`` for
  ``jax.scipy.linalg.expm``) to 2e-7, but Adam divides each step by the
  gradient's running RMS, so a parameter whose gradient is ~0 moves by
  about the learning rate in the direction of its rounding.

The port's f64 learned solvers are held to its f32 ones (1e-4 of the gap's
peak).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from torch_threads import one_thread  # noqa: F401  (a module fixture)

# The packages export functions under the modules' names.
jb = importlib.import_module("ml_audio_inpainting_tpu.classical.basisopt")
basisopt = importlib.import_module("ml_audio_inpainting_torch.classical.basisopt")
STFT = dict(n_fft=256, hop_length=64, win_length=256)
F = STFT["n_fft"] // 2 + 1


def _unitary(n, seed):
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    return (q * (np.diag(r) / np.abs(np.diag(r)))).astype(np.complex64)


def _clips(n=4000, seed=13):
    sig = speech_like_batch(np.random.default_rng(seed), 3, n / 16000)
    mask = np.ones_like(sig)
    for i, s in enumerate((1000, 2400, 3700)):
        mask[i, s : s + 160] = 0.0
    return sig, mask


def _tied_columns(seed):
    rng = np.random.default_rng(seed)
    mags = rng.choice([0.5, 1.0, 2.0], (3, F, 7)) * rng.choice([-1.0, 1.0], (3, F, 7))
    return np.where(rng.random((3, F, 7)) < 0.5, mags, 1j * mags).astype(np.complex64)


@pytest.mark.parametrize("k", [1, 4, 40, 200])
def test_hard_threshold_columns_with_ties_matches_jax(k):
    C = _tied_columns(k)
    want = np.asarray(jax.vmap(lambda c: jb.hard_threshold_columns(c, jnp.asarray(k)))(
        jnp.asarray(C)))
    got = basisopt.hard_threshold_columns(torch.from_numpy(C), torch.full((3,), k))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(basisopt.hard_threshold_columns(torch.from_numpy(C), k).numpy(),
                                  want)


@pytest.mark.parametrize("solver", ["aspain_learned", "sspain_learned"])
@pytest.mark.parametrize("basis", ["seeded", "identity"])
def test_learned_spain_matches_jax(solver, basis):
    sig, m = _clips()
    B = _unitary(F, 1) if basis == "seeded" else np.eye(F, dtype=np.complex64)
    kw = dict(maxit=12, s=2, r=2, **STFT)
    want = np.asarray(jax.vmap(lambda a, b: getattr(jb, solver)(a, b, jnp.asarray(B), **kw))(
        jnp.asarray(sig * m), jnp.asarray(m)))
    got = getattr(basisopt, solver)(torch.from_numpy(sig * m), torch.from_numpy(m),
                                    torch.from_numpy(B), **kw).numpy()
    gap = m == 0
    assert np.abs(got - want)[gap].max() <= 1e-5 * np.abs(want[gap]).max()
    if basis == "identity":  # a random basis sparsifies nothing: the best iterate is the input
        assert np.abs(got - sig * m)[gap].max() > 0
    np.testing.assert_array_equal(got[~gap], (sig * m)[~gap])


@pytest.mark.parametrize("solver", ["aspain_learned", "sspain_learned"])
def test_learned_spain_f64_agrees_with_f32(solver):
    sig, m = _clips()
    B = torch.from_numpy(_unitary(F, 2))
    kw = dict(maxit=12, **STFT)
    fn = getattr(basisopt, solver)
    got = fn(torch.from_numpy(sig * m).double(), torch.from_numpy(m).double(), B, **kw)
    want = fn(torch.from_numpy(sig * m), torch.from_numpy(m), B, **kw)
    assert got.dtype == torch.float64
    gap = torch.from_numpy(m == 0)
    assert (got[gap] - want[gap]).abs().max() <= 1e-4 * want[gap].abs().max()


def test_optimize_basis_matches_jax():
    rng = np.random.default_rng(4)
    mix = np.linalg.qr(rng.standard_normal((12, 12)))[0]
    X = (mix @ (rng.standard_normal((12, 40)) * (rng.random((12, 40)) < 0.2))).astype(np.complex64)
    kw = dict(level_init=0.05, epsilon=0.01, inner_steps=6, inner_lr=1e-2, max_outer=4)
    want_B, want_init, want_final = jb.optimize_basis(jnp.asarray(X), **kw)
    got_B, got_init, got_final = basisopt.optimize_basis(torch.from_numpy(X), **kw)
    assert got_B.dtype == torch.complex64
    np.testing.assert_allclose(got_B.numpy(), np.asarray(want_B), rtol=0, atol=2e-3)
    assert got_init == pytest.approx(want_init, rel=1e-6)
    assert got_final == pytest.approx(want_final, rel=1e-4)
    assert got_final < got_init
    eye = torch.eye(12, dtype=torch.complex64)
    torch.testing.assert_close(got_B @ got_B.conj().mT, eye, atol=1e-4, rtol=0)


def test_clip_gradient_is_one_half_at_the_bound_as_jax():
    x = torch.tensor([1.0, 0.5, -1.0, 2.0], requires_grad=True)
    basisopt._clip(x, torch.tensor(1.0)).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, -1.0, 1.0)))(jnp.array([1.0, 0.5, -1.0, 2.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))

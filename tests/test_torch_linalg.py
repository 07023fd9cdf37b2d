"""The port's ``ops/linalg.py`` against the JAX package's on the CPU:
autocorrelation, Levinson, LPC, Burg, the coefficients' autocorrelation and
the block-tridiagonal Cholesky solve with its ``ok`` flag.

The same numpy inputs (speech-like clips and AR processes from a seed) go
through JAX (vmapped over the batch; f64 under ``jax.enable_x64``) and the
port (the whole batch at once).  Bounds, as a share of the reference's
largest |value|:

* f64: 1e-9 (measured 6e-13 at most: the packages sum in other orders);
* f32: autocorrelation, Burg and the coefficients' autocorrelation 1e-5
  (measured 3e-7); LPC 2e-3 (measured 2.5e-4: Levinson on a harmonic signal
  is ill-conditioned, and f32 rounding in its partial sums grows through the
  recursion in both packages alike); the banded solve 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.ops import linalg as jl
from ml_audio_inpainting_torch.ops import linalg
from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from torch_threads import one_thread  # noqa: F401  (a module fixture)

F64_RTOL = 1e-9
DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}


def _x64(name):
    return jax.enable_x64(name == "f64")


def _assert_rel(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, err


def _ar_process(n, coefs, seed):
    rng = np.random.default_rng(seed)
    a = np.asarray(coefs[1:])
    p = len(a)
    x = np.zeros(n + 500)
    e = rng.standard_normal(n + 500) * 0.1
    for i in range(p, n + 500):
        x[i] = -np.dot(a, x[i - p : i][::-1]) + e[i]
    return x[500:]


def _clips():
    """Three speech-like rows and one AR(2) process, 4096 samples each."""
    speech = speech_like_batch(np.random.default_rng(11), 3, 4096 / 16000).astype(np.float64)
    return np.concatenate([speech, _ar_process(4096, [1.0, -1.5, 0.7], 2)[None]])


@pytest.mark.parametrize("name", ["f64", "f32"])
@pytest.mark.parametrize("maxlag", [16, 64])
def test_autocorrelation_matches_jax(name, maxlag):
    npdt, tdt = DTYPES[name]
    x = _clips().astype(npdt)
    with _x64(name):
        want = np.asarray(jl.autocorrelation(jnp.asarray(x), maxlag))
    got = linalg.autocorrelation(torch.from_numpy(x), maxlag)
    assert got.dtype == tdt
    _assert_rel(got, want, F64_RTOL if name == "f64" else 1e-5)


@pytest.mark.parametrize("name", ["f64", "f32"])
@pytest.mark.parametrize("p", [16, 64])
def test_levinson_and_lpc_match_jax(name, p):
    npdt, tdt = DTYPES[name]
    x = _clips().astype(npdt)
    with _x64(name):
        r = np.asarray(jax.vmap(lambda v: jl.autocorrelation(v, p))(jnp.asarray(x)))
        want_a, want_e = jax.vmap(lambda v: jl.levinson(v, p))(jnp.asarray(r))
        want_lpc = jax.vmap(lambda v: jl.lpc(v, p))(jnp.asarray(x))
    a, e = linalg.levinson(torch.from_numpy(r.copy()), p)
    got_lpc = linalg.lpc(torch.from_numpy(x), p)
    assert a.dtype == e.dtype == got_lpc.dtype == tdt
    rtol = F64_RTOL if name == "f64" else 2e-3
    _assert_rel(a, want_a, rtol)
    _assert_rel(e, want_e, rtol)
    _assert_rel(got_lpc, want_lpc, rtol)


def test_levinson_solves_the_toeplitz_system():
    import scipy.linalg

    x = _clips()
    r = linalg.autocorrelation(torch.from_numpy(x), 8)
    a, e = linalg.levinson(r, 8)
    for row, coef, err in zip(r.numpy(), a.numpy(), e.numpy()):
        direct = np.linalg.solve(scipy.linalg.toeplitz(row[:8]), -row[1:9])
        np.testing.assert_allclose(coef[1:], direct, rtol=1e-8)
        assert coef[0] == 1.0 and err > 0


@pytest.mark.parametrize("name", ["f64", "f32"])
@pytest.mark.parametrize("p", [16, 64])
def test_arburg_matches_jax(name, p):
    npdt, tdt = DTYPES[name]
    x = _clips().astype(npdt)
    with _x64(name):
        want = jax.vmap(lambda v: jl.arburg(v, p))(jnp.asarray(x))
    got = linalg.arburg(torch.from_numpy(x), p)
    assert got.dtype == tdt
    _assert_rel(got, want, F64_RTOL if name == "f64" else 1e-5)


@pytest.mark.parametrize("estimator", ["lpc", "arburg"])
def test_estimators_recover_an_ar2_process(estimator):
    x = torch.from_numpy(_ar_process(16384, [1.0, -1.5, 0.7], 1)[None])
    np.testing.assert_allclose(getattr(linalg, estimator)(x, 2)[0].numpy(), [1.0, -1.5, 0.7],
                               atol=0.03)


@pytest.mark.parametrize("name", ["f64", "f32"])
@pytest.mark.parametrize("p", [2, 16, 64])
def test_ar_coef_autocorr_matches_jax(name, p):
    npdt, tdt = DTYPES[name]
    coef = np.random.default_rng(p).standard_normal((3, p + 1)).astype(npdt)
    coef[:, 0] = 1.0
    with _x64(name):
        want = jax.vmap(lambda c: jl.ar_coef_autocorr(c, p))(jnp.asarray(coef))
    got = linalg.ar_coef_autocorr(torch.from_numpy(coef), p)
    assert got.dtype == tdt
    _assert_rel(got, want, F64_RTOL if name == "f64" else 1e-5)


def _banded_system(seed, q=16, nb=4):
    """An SPD matrix of bandwidth q and its (D, E) blocks."""
    rng = np.random.default_rng(seed)
    n = q * nb
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    A[np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > q] = 0.0
    A = A + n * np.eye(n)
    D = np.stack([A[k * q:(k + 1) * q, k * q:(k + 1) * q] for k in range(nb)])
    E = np.stack([A[(k + 1) * q:(k + 2) * q, k * q:(k + 1) * q] for k in range(nb - 1)]
                 + [np.zeros((q, q))])
    return A, D, E, rng.standard_normal(n)


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_block_tridiag_solve_matches_jax_and_dense(name):
    npdt, tdt = DTYPES[name]
    systems = [_banded_system(seed) for seed in range(3)]
    D, E, r = (np.stack([s[i] for s in systems]).astype(npdt) for i in (1, 2, 3))
    with _x64(name):
        want, want_ok = jax.vmap(jl.block_tridiag_cholesky_solve)(
            jnp.asarray(D), jnp.asarray(E), jnp.asarray(r))
    x, ok = linalg.block_tridiag_cholesky_solve(*(torch.from_numpy(v) for v in (D, E, r)))
    assert x.dtype == tdt and ok.dtype == torch.bool
    assert ok.tolist() == np.asarray(want_ok).tolist() == [True] * 3
    _assert_rel(x, want, F64_RTOL if name == "f64" else 1e-4)
    if name == "f64":
        for (A, *_), row, rhs in zip(systems, x.numpy(), r):
            np.testing.assert_allclose(row, np.linalg.solve(A, rhs), atol=1e-10)


def test_block_tridiag_flags_each_indefinite_system_as_jax_does():
    """One system of the batch has an indefinite second block: its flag is
    False in both packages, its solution finite (identity factors), and the
    other system is solved as usual."""
    q, nb = 4, 2
    D = np.stack([np.stack([np.eye(q), -np.eye(q)]), np.stack([2 * np.eye(q), 3 * np.eye(q)])])
    E = np.zeros((2, nb, q, q))
    r = np.ones((2, q * nb))
    want, want_ok = jax.vmap(jl.block_tridiag_cholesky_solve)(
        *(jnp.asarray(v, jnp.float32) for v in (D, E, r)))
    x, ok = linalg.block_tridiag_cholesky_solve(
        *(torch.from_numpy(v.astype(np.float32)) for v in (D, E, r)))
    assert ok.tolist() == np.asarray(want_ok).tolist() == [False, True]
    assert torch.isfinite(x).all()
    np.testing.assert_allclose(x.numpy(), np.asarray(want), rtol=1e-6)


def test_cholesky_reports_failure_on_the_tensor():
    a = torch.stack([torch.eye(3), -torch.eye(3), torch.diag(torch.tensor([1.0, 0.0, 1.0]))])
    L, ok = linalg.cholesky(a)
    assert ok.tolist() == [True, False, False]
    torch.testing.assert_close(L[0], torch.eye(3))

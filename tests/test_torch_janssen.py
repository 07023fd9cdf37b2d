"""The port's ``classical/janssen.py`` against the JAX package's on the CPU:
``janssen`` (dense and banded solvers, lpc and Burg fits, ``saveall``,
``ridge=0``, the frozen solution after a failed Cholesky) and
``janssen_gapwise`` (gaps near the clip's start, running past its end, and
starting past it: ``lax.dynamic_slice`` clamps those segments, and so does
the port).

The same numpy inputs go through JAX (vmapped over the clips) and the port
(batched).  Bounds:

* f64 (``jax.enable_x64``): 1e-9 of JAX's largest |sample| in the gaps
  (measured 7e-12).
* f32: the Janssen system is ill-conditioned (``ridge`` 1e-6 leaves a
  condition number up to ~1e6), so f32 rounding moves the solution by up to
  ~1e-2 of the gap's peak in both packages, each in its own direction.  The
  port's f32 result is held to the f64 one: no farther from it than twice
  JAX's f32 result is, plus 1e-6 of the peak.
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
jj = importlib.import_module("ml_audio_inpainting_tpu.classical.janssen")
port = importlib.import_module("ml_audio_inpainting_torch.classical.janssen")
N = 4096
GAPS = [(2000, 200), (1500, 256), (40, 200), (4000, 200), (4200, 100)]
F64_RTOL = 1e-9


def _inputs(gaps=GAPS, n=N, seed=7):
    sig = speech_like_batch(np.random.default_rng(seed), len(gaps), n / 16000).astype(np.float64)
    gs = np.array([g[0] for g in gaps])
    gl = np.array([g[1] for g in gaps])
    mask = np.ones_like(sig)
    for i, (s, l) in enumerate(gaps):
        mask[i, max(s, 0) : s + l] = 0.0
    return sig, mask, gs, gl


def _jax(fn, x, m, gs, gl, **kw):
    with jax.enable_x64(x.dtype == np.float64):
        return np.asarray(jax.vmap(lambda a, b, s, l: fn(a, b, s, l, **kw))(
            jnp.asarray(x), jnp.asarray(m), jnp.asarray(gs), jnp.asarray(gl)))


def _port(fn, x, m, gs, gl, **kw):
    out = fn(torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(gs),
             torch.from_numpy(gl), **kw)
    assert out.dtype == torch.from_numpy(x).dtype
    return out.numpy()


def _gap_err(got, want, mask):
    gap = np.broadcast_to(mask == 0, got.shape)
    return np.abs(got - want)[gap].max() / np.abs(want[gap]).max()


@pytest.mark.parametrize("solver,method", [("dense", "lpc"), ("banded", "lpc"),
                                           ("banded", "arburg")])
def test_janssen_matches_jax_f64(solver, method):
    sig, m, gs, gl = _inputs()
    kw = dict(p=16, maxit=3, method=method, max_gap=256, solver=solver)
    want = _jax(jj.janssen, sig * m, m, gs, gl, **kw)
    got = _port(port.janssen, sig * m, m, gs, gl, **kw)
    assert _gap_err(got, want, m) <= F64_RTOL
    np.testing.assert_array_equal(got[m > 0], (sig * m)[m > 0])


@pytest.mark.parametrize("solver", ["dense", "banded"])
def test_janssen_f32_is_as_close_to_f64_as_jax(solver):
    sig, m, gs, gl = _inputs()
    kw = dict(p=16, maxit=3, max_gap=256, solver=solver)
    exact = _jax(jj.janssen, sig * m, m, gs, gl, **kw)
    x32, m32 = (sig * m).astype(np.float32), m.astype(np.float32)
    jax32 = _jax(jj.janssen, x32, m32, gs, gl, **kw)
    got = _port(port.janssen, x32, m32, gs, gl, **kw)
    assert _gap_err(got, exact, m) <= 2 * _gap_err(jax32, exact, m) + 1e-6
    np.testing.assert_array_equal(got[m > 0], x32[m > 0])


def test_saveall_matches_jax_and_ends_at_the_solution():
    sig, m, gs, gl = _inputs()
    kw = dict(p=16, maxit=3, max_gap=256)
    want = _jax(jj.janssen, sig * m, m, gs, gl, saveall=True, **kw)
    got = _port(port.janssen, sig * m, m, gs, gl, saveall=True, **kw)
    assert got.shape == want.shape == (len(GAPS), 3, N)
    assert _gap_err(got, want, m[:, None]) <= F64_RTOL
    final = _port(port.janssen, sig * m, m, gs, gl, **kw)
    np.testing.assert_array_equal(got[:, -1], final)


def test_ridge_zero_matches_jax():
    sig, m, gs, gl = _inputs()
    kw = dict(p=16, maxit=2, max_gap=256, ridge=0.0)
    want = _jax(jj.janssen, sig * m, m, gs, gl, **kw)
    got = _port(port.janssen, sig * m, m, gs, gl, **kw)
    assert _gap_err(got, want, m) <= F64_RTOL


@pytest.mark.parametrize("solver", ["dense", "banded"])
def test_failed_cholesky_freezes_that_clip_only(solver):
    """A clip with an infinite observed sample makes every system of its own
    non-finite: its Cholesky fails at the first iteration and it keeps its
    starting solution (the gap zero-filled), in both packages; the other
    clips are solved as usual."""
    sig, m, gs, gl = _inputs(GAPS[:2])
    sig[0, 100] = np.inf
    kw = dict(p=16, maxit=2, max_gap=256, solver=solver)
    x = (sig * m).astype(np.float32)
    want = _jax(jj.janssen, x, m.astype(np.float32), gs, gl, **kw)
    got = _port(port.janssen, x, m.astype(np.float32), gs, gl, **kw)
    np.testing.assert_array_equal(got[0], x[0])
    np.testing.assert_array_equal(want[0], x[0])
    assert np.isfinite(got[1]).all()
    assert np.abs(got[1] - x[1])[m[1] == 0].max() > 0
    assert _gap_err(got[1:], want[1:], m[1:]) <= 2e-2


@pytest.mark.parametrize("gaps", [
    [(3000, 320), (5000, 200)],
    [(100, 320), (7900, 320)],           # near the start; running past the end
    [(8100, 320), (-300, 320)],          # starting past the end; before the start
], ids=["inside", "near-start-and-past-end", "clamped"])
def test_janssen_gapwise_matches_jax(gaps):
    sig, m, gs, gl = _inputs(gaps, n=8000, seed=3)
    kw = dict(p=16, maxit=2, max_gap=512, context=1024)
    want = _jax(jj.janssen_gapwise, sig * m, m, gs, gl, **kw)
    got = _port(port.janssen_gapwise, sig * m, m, gs, gl, **kw)
    if (m == 0).any():
        assert _gap_err(got, want, m) <= F64_RTOL
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_RTOL * np.abs(sig).max())
    np.testing.assert_array_equal(got[m > 0], sig[m > 0])


def test_janssen_restores_a_sine():
    """The JAX package's ``test_sine_gap_reconstruction`` on the port."""
    t = np.arange(8192) / 16000
    sig = np.sin(2 * np.pi * 440 * t)[None]
    m = np.ones_like(sig)
    m[:, 4000:4320] = 0.0
    out = _port(port.janssen, sig * m, m, np.array([4000]), np.array([320]), p=64, maxit=5,
                max_gap=512)
    err = out[0, 4000:4320] - sig[0, 4000:4320]
    assert 10 * np.log10((sig[0, 4000:4320] ** 2).sum() / (err ** 2).sum()) > 30.0


@pytest.mark.parametrize("solver,p,max_gap,banded", [
    ("auto", 16, 256, True), ("auto", 256, 256, False), ("auto", 48, 256, False),
    ("dense", 16, 256, False), ("banded", 16, 256, True)])
def test_solver_choice(solver, p, max_gap, banded):
    assert port.use_banded_solver(solver, p, max_gap) is banded


def test_bad_solver_options_raise():
    with pytest.raises(ValueError, match="solver"):
        port.use_banded_solver("lu", 16, 256)
    with pytest.raises(ValueError, match="max_gap % p"):
        port.use_banded_solver("banded", 48, 256)
    x = torch.zeros(1, 1024)
    with pytest.raises(ValueError, match="method"):
        port.janssen(x, torch.ones_like(x), torch.tensor([10]), torch.tensor([10]), p=4,
                     max_gap=16, method="yule")

"""The port's ``classical/ola.py`` and ``classical/spain.py`` against the
JAX package's on the CPU: the overlap-add windows, ``segmentation_inpaint``,
the DFT hard threshold (with ties), A-SPAIN, S-SPAIN, OMP and
``spain_inpaint`` with each algorithm.

The same numpy inputs go through JAX (vmapped over clips or windows) and the
port (batched).  Bounds:

* f64 (``jax.enable_x64``): 1e-9 of JAX's largest |sample| in the gaps
  (measured 3e-12 for the segmentation, 1e-15 for SPAIN).
* f32, SPAIN: 1e-5 of the gap's peak (measured 2e-7).  f32, segmentation:
  the Janssen solves inside it are ill-conditioned (see
  ``test_torch_janssen.py``), so the port's f32 result is held to the f64
  one: no farther from it than twice JAX's f32 result is, plus 1e-6.
* The windows: equal to JAX's up to one rounding of the f64 cosine (1e-15).

The hard threshold keeps every coefficient at least as large as the k-th
largest, so tied magnitudes at the threshold are all kept in both
packages, whichever order a sort puts them in.  The ties are held on real
and imaginary coefficients: torch's complex |z| and XLA's differ in the
last bit for other values, so magnitudes one bit apart could fall either
side of the threshold (ROADMAP, Queue C).
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
jo = importlib.import_module("ml_audio_inpainting_tpu.classical.ola")
js = importlib.import_module("ml_audio_inpainting_tpu.classical.spain")
ola = importlib.import_module("ml_audio_inpainting_torch.classical.ola")
spain = importlib.import_module("ml_audio_inpainting_torch.classical.spain")
F64_RTOL = 1e-9
N = 6000
GAPS = [(3000, 200), (4100, 160), (60, 200), (5900, 200)]


def _inputs(gaps=GAPS, n=N, seed=9):
    sig = speech_like_batch(np.random.default_rng(seed), len(gaps), n / 16000).astype(np.float64)
    gs = np.array([g[0] for g in gaps])
    gl = np.array([g[1] for g in gaps])
    mask = np.ones_like(sig)
    for i, (s, l) in enumerate(gaps):
        mask[i, max(s, 0) : s + l] = 0.0
    return sig, mask, gs, gl


def _both(jfn, tfn, x, m, gs, gl, **kw):
    with jax.enable_x64(x.dtype == np.float64):
        want = np.asarray(jax.vmap(lambda a, b, s, l: jfn(a, b, s, l, **kw))(
            jnp.asarray(x), jnp.asarray(m), jnp.asarray(gs), jnp.asarray(gl)))
    got = tfn(torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(gs),
              torch.from_numpy(gl), **kw)
    assert got.dtype == torch.from_numpy(x).dtype
    return got.numpy(), want


def _gap_err(got, want, mask):
    gap = mask == 0
    return np.abs(got - want)[gap].max() / np.abs(want[gap]).max()


@pytest.mark.parametrize("wtype", ["hann", "rect", "tukey"])
@pytest.mark.parametrize("w", [1024, 4096, 1001])
def test_ola_windows_match_jax(wtype, w):
    for npdt, tdt in ((np.float64, torch.float64), (np.float32, torch.float32)):
        with jax.enable_x64(npdt == np.float64):
            want = [np.asarray(v) for v in jo.ola_windows(wtype, w, npdt)]
        got = ola.ola_windows(wtype, w, tdt)
        for g, v in zip(got, want):
            assert g.dtype == tdt
            np.testing.assert_allclose(g.numpy(), v, rtol=1e-15 if npdt == np.float64 else 1e-7,
                                       atol=1e-15)


def test_unknown_window_raises():
    with pytest.raises(ValueError, match="OLA window"):
        ola.ola_windows("kaiser", 64)


@pytest.mark.parametrize("wtype", ["hann", "rect", "tukey"])
def test_segmentation_matches_jax_f64(wtype):
    sig, m, gs, gl = _inputs()
    kw = dict(p=16, maxit=2, wtype=wtype, w=1024, a=256, max_gap=256)
    got, want = _both(jo.segmentation_inpaint, ola.segmentation_inpaint, sig * m, m, gs, gl, **kw)
    assert _gap_err(got, want, m) <= F64_RTOL
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_RTOL * np.abs(sig).max())
    np.testing.assert_array_equal(got[m > 0], sig[m > 0])


def test_segmentation_f32_is_as_close_to_f64_as_jax():
    sig, m, gs, gl = _inputs()
    kw = dict(p=16, maxit=2, w=1024, a=256, max_gap=256)
    _, exact = _both(jo.segmentation_inpaint, ola.segmentation_inpaint, sig * m, m, gs, gl, **kw)
    x32, m32 = (sig * m).astype(np.float32), m.astype(np.float32)
    got, want = _both(jo.segmentation_inpaint, ola.segmentation_inpaint, x32, m32, gs, gl, **kw)
    assert _gap_err(got, exact, m) <= 2 * _gap_err(want, exact, m) + 1e-6
    np.testing.assert_array_equal(got[m > 0], x32[m > 0])


def _tied_spectrum(w, seed):
    """Half-spectrum coefficients with runs of equal magnitude, each purely
    real or purely imaginary (signs, axes and positions from a seed), so
    that |z| is exact in both packages, mirrored into a full
    conjugate-symmetric spectrum of ``w`` bins.  The DC bin, halved for the
    ranking, ties with the runs of half its size."""
    rng = np.random.default_rng(seed)
    nhalf = w // 2 + 1
    mags = rng.choice([0.25, 0.5, 1.0, 2.0], nhalf) * rng.choice([-1.0, 1.0], nhalf)
    half = np.where(rng.random(nhalf) < 0.5, mags, 1j * mags).astype(np.complex128)
    half[0] = 2 * mags[0]
    if w % 2 == 0:
        half[-1] = mags[-1]
    mirror = np.conj(half[1:-1][::-1]) if w % 2 == 0 else np.conj(half[1:][::-1])
    return np.concatenate([half, mirror])


@pytest.mark.parametrize("w", [64, 63])
@pytest.mark.parametrize("k", [1, 3, 10, 33, 100])
def test_hard_threshold_with_ties_matches_jax(w, k):
    z = np.stack([_tied_spectrum(w, s) for s in range(3)])
    with jax.enable_x64():
        want = np.asarray(jax.vmap(lambda v: js.hard_threshold_dft(v, jnp.asarray(k)))(
            jnp.asarray(z)))
    got = spain.hard_threshold_dft(torch.from_numpy(z), torch.full((3,), k))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(spain.hard_threshold_dft(torch.from_numpy(z), k).numpy(), want)
    # Every tie at the threshold is kept: at least k pairs survive.
    kept = (got.numpy()[:, : w // 2 + 1] != 0).sum(-1)
    assert (kept >= min(k, w // 2 + 1)).all()


def test_hard_threshold_per_row_k_matches_jax():
    z = np.stack([_tied_spectrum(64, s) for s in range(4)])
    ks = np.array([1, 5, 12, 40])
    with jax.enable_x64():
        want = np.asarray(jax.vmap(js.hard_threshold_dft)(jnp.asarray(z), jnp.asarray(ks)))
    got = spain.hard_threshold_dft(torch.from_numpy(z), torch.from_numpy(ks))
    np.testing.assert_array_equal(got.numpy(), want)


def _windows(w=512, count=4, seed=2):
    """Windowed speech-like blocks with a gap of w/8 somewhere inside each."""
    sig = speech_like_batch(np.random.default_rng(seed), count, w / 16000).astype(np.float64)
    mask = np.ones_like(sig)
    for i in range(count):
        s = w // 4 + i * w // 16
        mask[i, s : s + w // 8] = 0.0
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(w) / w)
    return sig * win * mask, mask, sig * win


@pytest.mark.parametrize("core", ["aspain_core", "sspain_core"])
@pytest.mark.parametrize("name", ["f64", "f32"])
def test_spain_cores_match_jax(core, name):
    npdt = np.float64 if name == "f64" else np.float32
    x, m, _ = _windows()
    x, m = x.astype(npdt), m.astype(npdt)
    kw = dict(maxit=20, s=2, r=3, epsilon=1e-3)
    with jax.enable_x64(name == "f64"):
        want = np.asarray(jax.vmap(lambda a, b: getattr(js, core)(a, b, **kw))(
            jnp.asarray(x), jnp.asarray(m)))
    got = getattr(spain, core)(torch.from_numpy(x), torch.from_numpy(m), **kw).numpy()
    assert _gap_err(got, want, m) <= (F64_RTOL if name == "f64" else 1e-5)
    np.testing.assert_array_equal(got[m > 0], x[m > 0])


@pytest.mark.parametrize("k,max_k,redundancy", [(3, 4, 2), (6, 6, 1), (9, 6, 2)])
def test_omp_matches_jax(k, max_k, redundancy):
    x, _, _ = _windows(w=256, seed=4)
    with jax.enable_x64():
        want = np.asarray(jax.vmap(lambda v: js.omp_approximation(
            v, jnp.asarray(k), max_k=max_k, redundancy=redundancy))(jnp.asarray(x)))
    got = spain.omp_approximation(torch.from_numpy(x), k, max_k=max_k, redundancy=redundancy)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F64_RTOL * np.abs(want).max())


def test_sspain_omp_core_matches_jax():
    x, m, _ = _windows(w=256, count=3, seed=5)
    kw = dict(maxit=6, f_update="omp", max_k=8)
    with jax.enable_x64():
        want = np.asarray(jax.vmap(lambda a, b: js.sspain_core(a, b, **kw))(
            jnp.asarray(x), jnp.asarray(m)))
    got = spain.sspain_core(torch.from_numpy(x), torch.from_numpy(m), **kw).numpy()
    assert _gap_err(got, want, m) <= F64_RTOL


@pytest.mark.parametrize("algorithm", ["aspain", "sspain", "sspain_omp"])
def test_spain_inpaint_matches_jax_f64(algorithm):
    # S-SPAIN with OMP runs 32 selections an iteration: two clips, two iterations.
    sig, m, gs, gl = _inputs(GAPS[2:] if algorithm == "sspain_omp" else GAPS)
    kw = dict(algorithm=algorithm, maxit=2 if algorithm == "sspain_omp" else 8, w=512, a=128,
              max_gap=256)
    got, want = _both(js.spain_inpaint, spain.spain_inpaint, sig * m, m, gs, gl, **kw)
    assert _gap_err(got, want, m) <= F64_RTOL
    np.testing.assert_array_equal(got[m > 0], sig[m > 0])


def test_spain_inpaint_matches_jax_f32():
    sig, m, gs, gl = _inputs()
    x32, m32 = (sig * m).astype(np.float32), m.astype(np.float32)
    got, want = _both(js.spain_inpaint, spain.spain_inpaint, x32, m32, gs, gl, algorithm="aspain",
                      maxit=20, w=512, a=128, max_gap=256)
    assert _gap_err(got, want, m) <= 1e-5
    np.testing.assert_array_equal(got[m > 0], x32[m > 0])


def test_aspain_restores_a_sine():
    """The JAX package's ``test_aspain_sine_gap`` on the port: > 10 dB."""
    t = np.arange(4096) / 16000
    sig = np.sin(2 * np.pi * 1000 * t)[None]
    m = np.ones_like(sig)
    m[:, 2000:2100] = 0.0
    out = spain.aspain_core(torch.from_numpy(sig * m), torch.from_numpy(m), maxit=50).numpy()
    err = out[0, 2000:2100] - sig[0, 2000:2100]
    assert 10 * np.log10((sig[0, 2000:2100] ** 2).sum() / (err ** 2).sum()) > 10.0


def test_unknown_spain_options_raise():
    x = torch.zeros(1, 4096)
    with pytest.raises(ValueError, match="algorithm"):
        spain.spain_inpaint(x, torch.ones_like(x), torch.tensor([100]), torch.tensor([10]),
                            algorithm="omp")
    with pytest.raises(ValueError, match="f_update"):
        spain.sspain_core(x, torch.ones_like(x), f_update="lasso")

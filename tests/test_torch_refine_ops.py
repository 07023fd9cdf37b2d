"""The waveform gap solvers in the port (``ops/refine.py``) against the JAX
package's (``ops/refine.py``) on the CPU, f32, on two seeded 1 s clips with
a 40 ms gap (STFT 256/64/256, ``tests/test_refiner.py``'s sizes).

Tolerances:

* ``consistent_reconstruct`` at 8 iterations: within 1e-4 of the gap's
  peak (measured up to 3.6e-6, with momentum): every projection divides by
  each coefficient's own magnitude, and the FFTs round apart;
* ``magnitude_descent`` at 5 Adam steps of lr 0.05: Adam divides each
  step by the gradient's RMS, so an entry whose gradient is rounding noise
  moves by lr on the sign of that noise.  Every gap sample within 2 lr a
  step of JAX's, all but 1 + 0.1 % within 1e-4 (measured: none past
  3.3e-6).  The flip witness: with the AR coefficients unflipped
  (``conv1d`` taken for a convolution) the port lies 0.45 away at a gap
  near the clip's end;
* outside the gap both return the observed samples bit for bit.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401  (a module fixture)

from ml_audio_inpainting_tpu.ops import refine as jax_refine
from ml_audio_inpainting_torch.ops import refine
from ml_audio_inpainting_torch.ops.stft import stft

jax_stft = importlib.import_module("ml_audio_inpainting_tpu.ops.stft").stft

KW = dict(n_fft=256, hop_length=64, win_length=256)
SR = 16000
N = 16000
GAP = slice(8000, 8640)
CR_RTOL = 1e-4
MD_LR = 0.05
MD_STEPS = 5
MD_NEAR = 1e-4


def _setup(seed=0, gap=GAP):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / SR
    clean = np.stack([0.5 * np.sin(2 * np.pi * rng.uniform(180, 260) * t)
                      + 0.25 * np.sin(2 * np.pi * rng.uniform(400, 500) * t + 0.7)
                      + 0.01 * rng.standard_normal(N) for _ in range(2)]).astype(np.float32)
    valid = np.ones_like(clean)
    valid[:, gap] = 0.0
    observed = clean * valid
    mag = np.abs(np.asarray(jax_stft(jnp.asarray(clean), **KW)))
    mag = (mag * rng.uniform(0.8, 1.2, mag.shape)).astype(np.float32)  # a model's estimate
    init = observed + (1 - valid) * (0.3 * clean + 0.05 * rng.standard_normal(clean.shape))
    frames = np.zeros((2, mag.shape[-1]), np.float32)
    frames[:, gap.start // 64 - 2: gap.stop // 64 + 3] = 1.0
    return {"mag": mag, "observed": observed, "valid": valid, "init": init.astype(np.float32),
            "frames": frames, "clean": clean}


def _both(fn_name, d, gap=GAP, **kw):
    jax_kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    port_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    args = (d["mag"], d["observed"], d["valid"], d["init"])
    want = np.asarray(getattr(jax_refine, fn_name)(*map(jnp.asarray, args), **jax_kw, **KW))
    got = getattr(refine, fn_name)(*map(torch.from_numpy, args), **port_kw, **KW).numpy()
    np.testing.assert_array_equal(got[:, :gap.start], d["observed"][:, :gap.start])
    np.testing.assert_array_equal(got[:, gap.stop:], d["observed"][:, gap.stop:])
    np.testing.assert_array_equal(want[:, :gap.start], got[:, :gap.start])
    return got, want


@pytest.mark.parametrize("momentum,beta,frames", [
    (0.0, 1.0, False), (0.5, 1.0, False), (0.5, 0.6, True), (0.0, 0.6, False)],
    ids=["plain", "momentum", "momentum-relaxed-frames", "relaxed"])
def test_consistent_reconstruct_matches_jax(momentum, beta, frames):
    d = _setup()
    kw = dict(n_iter=8, momentum=momentum, beta=beta)
    if frames:
        kw["mag_frames"] = d["frames"]
    got, want = _both("consistent_reconstruct", d, **kw)
    err = np.abs(got - want)[:, GAP].max()
    assert err <= CR_RTOL * np.abs(want[:, GAP]).max(), err


def test_consistent_reconstruct_length_and_refusals():
    d = _setup(1)
    args = [torch.from_numpy(d[k]) for k in ("mag", "observed", "valid", "init")]
    out = refine.consistent_reconstruct(*args, n_iter=2, length=12000, **KW)
    assert out.shape == (2, 12000)
    for bad in (dict(momentum=1.0), dict(momentum=-0.1), dict(beta=1.5), dict(beta=-0.5)):
        name = next(iter(bad))
        with pytest.raises(ValueError, match=name):
            refine.consistent_reconstruct(*args, n_iter=1, **bad, **KW)
        with pytest.raises(ValueError, match=name):
            jax_refine.consistent_reconstruct(*[jnp.asarray(a.numpy()) for a in args], n_iter=1,
                                              **bad, **KW)


def _ar_coef(seed=2, p=24):
    """Asymmetric error filters ``[1, a1..ap]`` (a stable decaying AR)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, p)) * 0.6 ** np.arange(1, p + 1)
    return np.concatenate([np.ones((2, 1)), a], axis=1).astype(np.float32)


def _check_descent(got, want, gap=GAP):
    err = np.abs(got - want)[:, gap]
    assert err.max() <= 2 * MD_LR * MD_STEPS, err.max()
    far = int((err > MD_NEAR).sum())
    assert far <= 1 + 1e-3 * err.size, f"{far} of {err.size} samples far, max {err.max()}"


@pytest.mark.parametrize("log_domain,ar_weight,prox_weight,frames", [
    (True, 0.0, 0.0, False), (False, 0.0, 0.0, True), (True, 0.5, 0.0, False),
    (True, 0.0, 2.0, True), (False, 0.3, 1.0, False)],
    ids=["log", "linear-frames", "log-ar", "log-prox-frames", "linear-ar-prox"])
def test_magnitude_descent_matches_jax(log_domain, ar_weight, prox_weight, frames):
    d = _setup(3)
    kw = dict(n_steps=MD_STEPS, lr=MD_LR, log_domain=log_domain, ar_weight=ar_weight,
              prox_weight=prox_weight)
    if ar_weight > 0:
        kw["ar_coef"] = _ar_coef()
    if frames:
        kw["mag_frames"] = d["frames"]
    got, want = _both("magnitude_descent", d, **kw)
    _check_descent(got, want)


def test_magnitude_descent_ar_term_is_a_convolution(monkeypatch):
    """The witness: the AR-only objective with the coefficients unflipped
    (a correlation, ``conv1d``'s plain meaning) lands far from JAX's
    ``jnp.convolve``.  Inside the clip a filter and its reverse have the
    same autocorrelation, so the objectives differ only where the valid
    residual starts and ends: the gap here ends 8 samples before the clip
    does, inside the filter's reach."""
    gap = slice(N - 208, N - 8)
    d = _setup(4, gap)
    kw = dict(n_steps=MD_STEPS, lr=MD_LR, mag_weight=0.0, ar_weight=1.0, ar_coef=_ar_coef(5))
    got, want = _both("magnitude_descent", d, gap, **kw)
    _check_descent(got, want, gap)
    monkeypatch.setattr(torch.Tensor, "flip", lambda self, dims: self)
    wrong = refine.magnitude_descent(*[torch.from_numpy(d[k]) for k in
                                       ("mag", "observed", "valid", "init")],
                                     **{**kw, "ar_coef": torch.from_numpy(kw["ar_coef"])}, **KW)
    assert np.abs(wrong.numpy() - want)[:, gap].max() > 10 * MD_NEAR
    with pytest.raises(ValueError, match="ar_coef"):
        refine.magnitude_descent(*[torch.from_numpy(d[k]) for k in
                                   ("mag", "observed", "valid", "init")], ar_weight=1.0, **KW)


def test_solvers_run_in_f64_and_stay_sync_free_shapes():
    """f64 in, f64 out (the card checks f64 against the CPU); the oracle
    magnitude pulls the gap toward the clean signal."""
    d = _setup(6)
    args = [torch.from_numpy(d[k]).double() for k in ("mag", "observed", "valid", "init")]
    mag = stft(torch.from_numpy(d["clean"]).double(), **KW).abs()
    out = refine.consistent_reconstruct(mag, *args[1:], n_iter=30, **KW)
    assert out.dtype == torch.float64
    clean = torch.from_numpy(d["clean"]).double()
    before = ((args[3] - clean)[:, GAP] ** 2).sum()
    after = ((out - clean)[:, GAP] ** 2).sum()
    assert after < before
    md = refine.magnitude_descent(mag, *args[1:], n_steps=3, **KW)
    assert md.dtype == torch.float64 and torch.isfinite(md).all()

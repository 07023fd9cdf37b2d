"""The port's ``classical/arinpaint.py`` against the JAX package's on the CPU.

The same numpy inputs (speech-like clips from a seed, one gap a clip) go
through JAX's ``arinpaint`` vmapped over the clips and through the port's
batched one.  Bounds, as a share of JAX's largest |sample| inside the gaps:
f64 (``jax.enable_x64``) 1e-9 (measured 6e-14), f32 5e-4 (measured 5e-5:
f32 rounding of the two Levinson fits, carried through the extrapolation).

The gaps include one near the clip's start (the pre-gap context reaches
into the zero padding), one that runs past the clip's end and one that
starts past it (``lax.dynamic_slice`` and ``dynamic_update_slice`` clamp
those windows; the port clamps them the same way).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.classical.arinpaint import ar_extrapolate as jax_ar_extrapolate
from ml_audio_inpainting_tpu.classical.arinpaint import arinpaint as jax_arinpaint
from ml_audio_inpainting_torch.ops.linalg import lpc
from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from torch_threads import one_thread  # noqa: F401  (a module fixture)

# The package exports a function under the module's name.
port = importlib.import_module("ml_audio_inpainting_torch.classical.arinpaint")
N = 8000
GAPS = [(3000, 320), (4200, 200), (100, 320), (7900, 320), (8100, 320)]  # near start, past end
RTOL = {"f64": 1e-9, "f32": 5e-4}
DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}


def _inputs(npdt, gaps=GAPS):
    sig = speech_like_batch(np.random.default_rng(5), len(gaps), N / 16000).astype(np.float64)
    gs = np.array([g[0] for g in gaps])
    gl = np.array([g[1] for g in gaps])
    mask = np.ones_like(sig)
    for i, (s, l) in enumerate(gaps):
        mask[i, max(s, 0) : s + l] = 0.0
    return (sig * mask).astype(npdt), mask.astype(npdt), gs, gl


def _both(name, **kw):
    npdt, tdt = DTYPES[name]
    x, m, gs, gl = _inputs(npdt)
    with jax.enable_x64(name == "f64"):
        want = np.asarray(jax.vmap(lambda a, b, s, l: jax_arinpaint(a, b, s, l, **kw))(
            jnp.asarray(x), jnp.asarray(m), jnp.asarray(gs), jnp.asarray(gl)))
    got = port.arinpaint(torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(gs),
                         torch.from_numpy(gl), **kw)
    assert got.dtype == tdt
    return x, m, got.numpy(), want


def _assert_gap_close(got, want, mask, rtol):
    gap = mask == 0
    err = np.abs(got - want)[gap].max() / np.abs(want[gap]).max()
    assert err <= rtol, err


@pytest.mark.parametrize("name", ["f64", "f32"])
@pytest.mark.parametrize("order,steps", [(8, 64), (32, 300)])
def test_ar_extrapolate_matches_jax(name, order, steps):
    npdt, _ = DTYPES[name]
    x, _, _, _ = _inputs(npdt)
    coef = lpc(torch.from_numpy(x[:, :2000]), order).numpy()
    tail = x[:, 2000 - order : 2000]
    with jax.enable_x64(name == "f64"):
        want = np.asarray(jax.vmap(lambda c, t: jax_ar_extrapolate(c, t, order, steps))(
            jnp.asarray(coef), jnp.asarray(tail)))
    got = port.ar_extrapolate(torch.from_numpy(coef), torch.from_numpy(tail), order, steps)
    assert got.shape == (len(x), steps)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL[name] * np.abs(want).max())


@pytest.mark.parametrize("method", ["lpc", "arburg"])
@pytest.mark.parametrize("blend,blend_param", [("cos2", 0.0), ("linear", 0.2), ("sigmoid", 2.0),
                                               ("sigmoid", 0.0)])
def test_arinpaint_matches_jax_f64(method, blend, blend_param):
    x, m, got, want = _both("f64", order=32, context=1024, max_gap=512, method=method,
                            blend=blend, blend_param=blend_param)
    _assert_gap_close(got, want, m, RTOL["f64"])
    # Outside the gaps the output is the input, bit for bit.
    np.testing.assert_array_equal(got[m > 0], x[m > 0])
    np.testing.assert_array_equal(want[m > 0], x[m > 0])


@pytest.mark.parametrize("method,blend", [("lpc", "cos2"), ("arburg", "linear")])
def test_arinpaint_matches_jax_f32(method, blend):
    x, m, got, want = _both("f32", order=32, context=1024, max_gap=512, method=method,
                            blend=blend, blend_param=0.3)
    _assert_gap_close(got, want, m, RTOL["f32"])
    np.testing.assert_array_equal(got[m > 0], x[m > 0])


def test_arinpaint_restores_a_sine():
    """The JAX package's ``test_sine_extrapolation`` on the port: > 25 dB."""
    t = np.arange(8192) / 16000
    sig = np.sin(2 * np.pi * 500 * t)[None]
    mask = np.ones_like(sig)
    mask[:, 4000:4320] = 0.0
    out = port.arinpaint(torch.from_numpy(sig * mask), torch.from_numpy(mask),
                         torch.tensor([4000]), torch.tensor([320]), order=32, context=2048,
                         max_gap=512).numpy()
    err = out[0, 4000:4320] - sig[0, 4000:4320]
    assert 10 * np.log10((sig[0, 4000:4320] ** 2).sum() / (err ** 2).sum()) > 25.0


@pytest.mark.parametrize("blend", ["cos2", "linear", "sigmoid"])
def test_blend_weights_run_from_forward_to_backward(blend):
    t = torch.linspace(0, 1, 101, dtype=torch.float64)
    w = port.blend_weights(t, blend, 0.2 if blend == "linear" else 0.0)
    assert torch.all(w[:-1] >= w[1:]) and w[0] > 0.5 > w[-1]
    torch.testing.assert_close(w + w.flip(0), torch.ones_like(w))


def test_unknown_options_raise():
    x = torch.zeros(1, 4000)
    with pytest.raises(ValueError, match="blend"):
        port.arinpaint(x, torch.ones_like(x), torch.tensor([1000]), torch.tensor([100]),
                       order=4, context=256, max_gap=128, blend="hann")
    with pytest.raises(ValueError, match="method"):
        port.arinpaint(x, torch.ones_like(x), torch.tensor([1000]), torch.tensor([100]),
                       order=4, context=256, max_gap=128, method="yule")


def test_f32_defaults_fail_on_formant_2_as_in_jax():
    """Found in the reference: at the CLI's defaults (order 512, context 4096)
    the f32 Levinson on ``formant_2.flac``'s pre-gap context runs its
    prediction error below zero and the extrapolation overflows (1e30 and
    up, then NaN), in JAX and in the port alike.  In f64 it is finite."""
    from pathlib import Path

    from ml_audio_inpainting_torch.data.audio_io import load_audio

    flac = Path(__file__).resolve().parent.parent / "results" / "formant_corpus_samples"
    x = load_audio(flac / "formant_2.flac", sample_rate=16000, max_len=5.0)[0][None]
    m = np.ones_like(x)
    m[:, 32000:33280] = 0.0
    kw = dict(order=512, context=4096, max_gap=2048)
    want = np.asarray(jax.vmap(lambda a, b: jax_arinpaint(a, b, 32000, 1280, **kw))(
        jnp.asarray(x * m), jnp.asarray(m)))
    gs, gl = torch.tensor([32000]), torch.tensor([1280])
    got = port.arinpaint(torch.from_numpy(x * m), torch.from_numpy(m), gs, gl, **kw).numpy()
    exact = port.arinpaint(torch.from_numpy(x * m).double(), torch.from_numpy(m).double(), gs,
                           gl, **kw).numpy()
    gap = m == 0
    assert not np.isfinite(want[gap]).all() and not np.isfinite(got[gap]).all()
    assert np.isfinite(exact).all()
    np.testing.assert_array_equal(got[~gap], (x * m)[~gap])

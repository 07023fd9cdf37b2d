"""Training the gap refiner in the port (``train/refiner_trainer.py``'s
step and gap draws, ``cli/train_refiner.py``) against the JAX package's on
the CPU, with ``tests/test_torch_refiner.py``'s tiny GAN, committed head,
clips and bounds:

* the step's loss and AR baseline within 1e-3 absolute (log energy ratios
  of order 1, carrying the AR channel's rounding, 5e-4 of its peak);
* parameters after one Adam step (lr 3e-4): within 2 lr of JAX's (the
  sign-flip bound of ``tests/test_torch_gan_train.py``: an entry whose
  gradient is rounding noise moves +-lr in either package) and all but
  1 + 0.1 % of a tensor within 0.05 lr;
* the candidate pick takes an f32 cumulative sum over the clip, which may
  break a near-tie otherwise than XLA's: the step test's clips put their
  candidates' energies well apart (a quiet and a loud half), so both
  packages pick the same gap; JAX's draws from its key are handed to the
  port;
* the CLI's export served by JAX's apply function and the port's within the
  AR bound, 5e-4 of the peak.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_refiner import (
    AR_RTOL,
    HEAD,
    LOSS_ATOL,
    LR,
    PARAM_LR_SHARE,
    S,
    SR,
    flatten,
    jax_state,
    speech,
    tiny,  # noqa: F401  (a module fixture)
)
from torch_threads import one_thread  # noqa: F401  (a module fixture)

from ml_audio_inpainting_tpu.train import refiner_trainer as jrt
from ml_audio_inpainting_tpu.train.checkpoints import load_params_npz as jax_load_npz
from ml_audio_inpainting_torch.cli import train_refiner
from ml_audio_inpainting_torch.train import refiner_trainer as rt
from ml_audio_inpainting_torch.train.checkpoints import export_params_npz
from ml_audio_inpainting_torch.weights import load_params_npz, refiner_flat_variables


def _jax_draws(key, b, n, cfg, k=8):
    """The gap lengths and candidates JAX's step draws from ``key``."""
    lo, hi = int(0.04 * SR), min(int(0.128 * SR), jrt.MAX_GAP)
    k1, k2 = jax.random.split(key)
    gl = jax.random.randint(k1, (b,), lo, hi + 1)
    cands = jax.random.randint(k2, (b, k), 8192, n - 8192 - hi)
    return (torch.tensor(np.asarray(gl), dtype=torch.int64),
            torch.tensor(np.asarray(cands), dtype=torch.int64))


def test_train_step_matches_jax_on_jaxs_draws(tiny):
    """One step from the committed head (a fresh head moves only its last
    projection) at B=2: the loss, the AR baseline and every parameter after
    Adam."""
    audio = speech(7, 2, loud_half=True)
    key = jax.random.PRNGKey(9)
    flat = load_params_npz(HEAD)
    jstate = jax_state(jax_load_npz(HEAD)["params"])
    jstep = jrt.make_refiner_train_step(tiny["jcfg"], tiny["net"], tiny["vars"])
    jstate, jm = jstep(jstate, jnp.asarray(audio), key)
    state = rt.create_refiner_state(lr=LR, device="cpu", params=flat)
    state, m = rt.make_refiner_train_step(tiny["cfg"], tiny["gen"])(
        state, torch.from_numpy(audio), *_jax_draws(key, 2, S, tiny["cfg"]))
    assert m["loss"].item() == pytest.approx(float(jm["loss"]), abs=LOSS_ATOL)
    assert m["ar_baseline"].item() == pytest.approx(float(jm["ar_baseline"]), abs=LOSS_ATOL)
    assert state.step == 1
    got = refiner_flat_variables(state.model.state_dict())
    want = flatten({"params": jstate.params})
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.abs(got[k] - w)
        assert err.max() <= 2 * LR, f"{k}: {err.max()} > 2 lr"
        far = int((err > PARAM_LR_SHARE * LR + 1e-7).sum())
        assert far <= 1 + 1e-3 * err.size, f"{k}: {far} of {err.size} entries far"
        assert np.abs(got[k] - flat[k]).max() > 0 or np.abs(w - flat[k]).max() == 0, k


def test_train_step_is_finite_with_a_gap_in_silence(tiny):
    """Near-silent clips: the AR fit may blow up; the clip at +-4 keeps the
    step's loss and the head's parameters finite.  The draws come from
    :func:`draw_refiner_gaps` on the CPU."""
    audio = speech(8, 2) * 1e-6
    state = rt.create_refiner_state(torch.Generator().manual_seed(0), channels=8, device="cpu")
    gen = torch.Generator().manual_seed(1)
    gl, cands = rt.draw_refiner_gaps(gen, tiny["cfg"], 2, S)
    assert ((gl >= 640) & (gl <= 2048)).all() and cands.shape == (2, 8)
    assert ((cands >= rt.MARGIN) & (cands < S - rt.MARGIN - 2048)).all()
    state, m = rt.make_refiner_train_step(tiny["cfg"], tiny["gen"])(
        state, torch.from_numpy(audio), gl, cands)
    assert np.isfinite(m["loss"].item()) and np.isfinite(m["ar_baseline"].item())
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_train_refiner_cli_three_steps_served_by_jax(tiny, tmp_path):
    """``train_refiner`` on the CPU: 3 steps at B=2, C=8, probes at steps 0
    and 2; the export (the probe-best head) loads in JAX and JAX's apply
    function serves it as the port's serves it."""
    gan_yaml = tmp_path / "gan.json"
    gan_yaml.write_text(json.dumps(tiny["cfg"].to_dict()))
    gan_npz = tmp_path / "gan.npz"
    export_params_npz(gan_npz, tiny["gen"], dtype=None)
    out = tmp_path / "head.npz"
    res = train_refiner.main([
        "--synthetic", "6", "--corpus", "formant_v2", "--steps", "3", "--batch-size", "2",
        "--channels", "8", "--gan-checkpoint", str(gan_npz), "--gan-config", str(gan_yaml),
        "--probe-every", "2", "--probe-clips", "2", "--out", str(out), "--device", "cpu"])
    assert [p[0] for p in res.probes] == [0, 2] and res.best_step in (0, 2)
    assert [s for s, *_ in res.logs] == [0] and np.isfinite(res.logs[0][1])
    assert out.exists() and res.state.step == 3
    jvars = jax_load_npz(out)
    assert jrt.refiner_channels(jvars) == 8
    audio = speech(9, 2)
    gs, gl = np.array([9000, 14000]), np.array([1280, 1280])
    want = np.asarray(jrt.make_refiner_apply_fn(tiny["jcfg"], tiny["net"], tiny["vars"],
                                                channels=8)(
        jvars, jnp.asarray(audio), jnp.asarray(gs), jnp.asarray(gl)))
    got = rt.make_refiner_apply_fn(tiny["cfg"], tiny["gen"])(
        rt.load_refiner(load_params_npz(out), "cpu"), torch.from_numpy(audio),
        torch.from_numpy(gs), torch.from_numpy(gl)).numpy()
    assert np.abs(got - want).max() <= AR_RTOL * np.abs(want).max()

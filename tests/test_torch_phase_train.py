"""Phase-mode CNN+BiLSTM training in the port (``make_cnn_train_step`` and
``make_cnn_eval_step`` with ``phase_mode`` and ``phase_anchor``) against the
JAX package's on the CPU, f32, and the port's bf16 step against its f32
step.

Narrow model (enc [4, 8], hidden 16, 2 layers, 2 input channels; 2 clips x
2 variants of 0.5 s, 257 x 42), every leaf redrawn from a seeded numpy
generator (``tests/test_torch_cnn_train.py::_redraw``); gap positions are
JAX's, from its key (``_starts_of_key``).  Tolerances:

* the loss to rtol 1e-5 and the gradients per tensor within 1e-4 of the
  tensor's largest entry, as the f32 step of
  ``tests/test_torch_cnn_train.py``;
* parameters after Adam steps: as there, except that of the entries of all
  the other parameters together (the conv biases in front of BatchNorm are
  held as there) up to 1e-4 may move by up to 2 lr a step (not 2e-2 lr):
  Adam divides each gradient entry by its own RMS, and the complex L1 gives
  some entries a gradient within the packages' rounding of zero, whose sign
  then decides a move of +-lr (seen: 1 entry of 307 088, in BiLSTM layer
  0's input weights);
* the bf16 step against the f32 step (both the port's): the loss to rtol
  2e-2 and every gradient tensor in L2 within 0.3 of its norm, the bounds
  of ``tests/test_torch_bf16_train.py``'s loss and of ``chip_smoke.py``'s
  bf16 check (``BF16_GRAD_L2_RTOL``); the conv biases in front of BatchNorm
  (rounding noise in both) are not held.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ml_audio_inpainting_tpu.train import cnn_trainer as jax_trainer
from ml_audio_inpainting_tpu.train import features as jax_features
from ml_audio_inpainting_tpu.train.losses import cnn_phase_l1_loss as jax_phase_l1
from ml_audio_inpainting_tpu.utils.config import Config as JaxConfig
from ml_audio_inpainting_torch.train.cnn_trainer import (
    create_cnn_state,
    make_cnn_eval_step,
    make_cnn_train_step,
)
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.weights import cnn_blstm_flat_variables
from test_torch_cnn_train import (
    GAP_S,
    N_SAMPLES,
    NOISE_GRAD,
    SR,
    VARIANTS,
    _assert_grads_close,
    _assert_variables_close,
    _audio,
    _redraw,
    _starts_of_key,
    flatten,
)
from test_torch_phase_cnn import N_FRAMES, _phase_cfg_dict
from torch_threads import one_thread  # noqa: F401  (a module fixture)


@functools.lru_cache(maxsize=None)
def _jax_phase_state(lr, ema):
    """JAX's phase-mode state with every leaf redrawn (immutable, so shared
    between tests: its eager init is the slow part)."""
    jcfg = JaxConfig.from_dict(_phase_cfg_dict(lr=lr))
    net = jax_trainer.build_model(jcfg)
    variables = jax.jit(lambda k, a: net.init(k, a, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 257, N_FRAMES, 2)))
    rng = np.random.default_rng(1)
    params = _redraw(variables["params"], rng)
    # create_cnn_state's state, built around a jitted init (its own is eager).
    return jcfg, jax_trainer.CNNTrainState.create(
        apply_fn=net.apply, params=params, batch_stats=_redraw(variables["batch_stats"], rng),
        ema_params=jax.tree_util.tree_map(jnp.array, params) if ema > 0 else None,
        tx=optax.adam(lr))


def _phase_states(lr=1e-3, ema=0.0):
    jcfg, jstate = _jax_phase_state(lr, ema)
    cfg = Config.from_dict(_phase_cfg_dict(lr=lr))
    flat = flatten({"params": jstate.params, "batch_stats": jstate.batch_stats})
    return jcfg, cfg, jstate, create_cnn_state(cfg, device="cpu", params=flat, ema=ema)



@functools.lru_cache(maxsize=None)
def _jax_phase_grad_fn(apply_fn):
    """The loss and gradients of JAX's phase-mode step (``loss_fn`` of
    ``cnn_trainer.make_cnn_train_step``), jitted once for the plain and the
    anchored features."""

    def loss_fn(params, batch_stats, spec_gap, target, gap_mask):
        pred, _ = apply_fn({"params": params, "batch_stats": batch_stats}, spec_gap, train=True,
                           mutable=["batch_stats"])
        return jax_phase_l1(pred, target, gap_mask)

    return jax.jit(jax.value_and_grad(loss_fn))


def _jax_phase_loss_and_grads(jcfg, state, audio, key, anchored):
    batch = jax_features.cnn_phase_features(
        jnp.asarray(audio), key, jcfg.data.spectrogram, gap_len_s=GAP_S, sample_rate=SR,
        n_samples=N_SAMPLES, gaps_per_audio=VARIANTS, anchored=anchored)
    loss, grads = _jax_phase_grad_fn(state.apply_fn)(
        state.params, state.batch_stats, batch["spec_gap"], batch["target"], batch["gap_mask"])
    return float(loss), flatten({"params": grads})


@pytest.mark.parametrize("anchored", [False, True], ids=["plain", "anchored"])
def test_phase_step_loss_and_gradients_match_jax(anchored):
    jcfg, cfg, jstate, state = _phase_states()
    audio = _audio(1)
    key = jax.random.PRNGKey(11)
    want_loss, want_grads = _jax_phase_loss_and_grads(jcfg, jstate, audio, key, anchored)
    _, m = make_cnn_train_step(cfg, phase_mode=True, phase_anchor=anchored)(
        state, torch.tensor(audio), _starts_of_key(key))
    np.testing.assert_allclose(m["loss"].item(), want_loss, rtol=1e-5)
    got = cnn_blstm_flat_variables({n: p.grad for n, p in state.model.named_parameters()})
    _assert_grads_close(got, want_grads)


def test_phase_train_steps_and_eval_step_match_jax():
    """The eval step's loss; then two anchored steps with the EMA from the
    same variables and gaps: the losses, the parameters, ``batch_stats`` and
    the EMA."""
    lr, ema, steps = 1e-3, 0.9, 2
    jcfg, cfg, jstate, state = _phase_states(lr, ema)
    audio = _audio(5)
    key = jax.random.PRNGKey(5)
    want_eval = jax_trainer.make_cnn_eval_step(jcfg, phase_mode=True, phase_anchor=True)(
        jstate, jnp.asarray(audio), key)["loss"]
    got = make_cnn_eval_step(cfg, phase_mode=True, phase_anchor=True)(
        state, torch.tensor(audio), _starts_of_key(key))["loss"]
    np.testing.assert_allclose(got.item(), float(want_eval), rtol=1e-5)
    assert not state.model.training

    jstep = jax_trainer.make_cnn_train_step(jcfg, ema=ema, phase_mode=True, phase_anchor=True)
    step = make_cnn_train_step(cfg, ema=ema, phase_mode=True, phase_anchor=True)
    for i in range(steps):
        audio = _audio(20 + i)
        key = jax.random.PRNGKey(200 + i)
        jstate, jm = jstep(jstate, jnp.asarray(audio), key)
        state, m = step(state, torch.tensor(audio), _starts_of_key(key))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    want = flatten({"params": jstate.params, "batch_stats": jstate.batch_stats})
    got = cnn_blstm_flat_variables(state.model.state_dict())
    _assert_variables_close({k: v for k, v in got.items() if k.startswith("batch_stats/")},
                            {k: v for k, v in want.items() if k.startswith("batch_stats/")},
                            lr * steps)
    for name, got_p, want_p in (
            ("params", {k: v for k, v in got.items() if k.startswith("params/")},
             {k: v for k, v in want.items() if k.startswith("params/")}),
            ("ema", cnn_blstm_flat_variables(state.ema_params),
             flatten({"params": jstate.ema_params}))):
        assert set(got_p) == set(want_p)
        _assert_variables_close({k: got_p[k] for k in NOISE_GRAD},
                                {k: want_p[k] for k in NOISE_GRAD}, lr * steps)
        err = np.concatenate([np.abs(got_p[k] - want_p[k]).ravel() for k in sorted(want_p)
                              if k not in NOISE_GRAD])
        assert err.max() <= 2 * lr * steps, (name, err.max())
        assert (err > 1e-6 + 2e-2 * lr * steps).sum() <= 1e-4 * err.size, (
            name, (err > 1e-6 + 2e-2 * lr * steps).sum())


def test_phase_bf16_step_against_f32():
    _, cfg, _, state32 = _phase_states()
    _, _, _, state16 = _phase_states()
    audio = torch.tensor(_audio(3))
    starts = _starts_of_key(jax.random.PRNGKey(3))
    _, m32 = make_cnn_train_step(cfg, phase_mode=True, phase_anchor=True)(state32, audio, starts)
    _, m16 = make_cnn_train_step(cfg, compute_dtype=torch.bfloat16, phase_mode=True,
                                 phase_anchor=True)(state16, audio, starts)
    np.testing.assert_allclose(m16["loss"].item(), m32["loss"].item(), rtol=2e-2)
    g32 = dict(state32.model.named_parameters())
    for name, p in state16.model.named_parameters():
        assert p.dtype == torch.float32
        want = g32[name].grad
        err = (p.grad - want).norm().item()
        if name.endswith("bias") and ("conv" in name and not name.startswith("dec_conv2")):
            continue  # in front of BatchNorm: rounding noise in both
        assert err <= 0.3 * want.norm().item(), f"{name}: {err} vs {want.norm().item()}"



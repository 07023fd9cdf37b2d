"""bf16 CNN+BiLSTM training in the port (``make_cnn_train_step(cfg,
compute_dtype=torch.bfloat16)``, the bf16 rule of ``FlaxBatchNorm2d``, the
whole model on bf16 parameters) against the JAX package's bf16 recipe
(``make_cnn_train_step(cfg, compute_dtype=jnp.bfloat16)``) on the CPU, with
three gaps a clip (``train_n_gaps=3``).

The JAX side builds ``StackedBLSTMCNN(..., use_pallas_lstm=True)`` into its
own ``CNNTrainState``: the bf16 reference is the Pallas recurrence (here in
interpret mode), which carries f32 state, not ``lax.scan``, which carries
bf16 (``tests/test_torch_bf16_lstm.py``).  Both steps start from the same
redrawn f32 variables (as in ``tests/test_torch_cnn_train.py``) and see the
same gap positions (JAX's, from its key).  Narrow model (enc [4, 8], hidden
16, 2 layers), 2 clips x 2 variants of 1.2 s (257 x 101): three gaps and
their 4096-sample spacing need more than 1.03 s.

What the tolerances allow.  bf16 keeps 8 bits, and the two packages round
at different places: XLA's bf16 convolutions on the CPU land up to two bf16
ulps from the rounded f32 result (the port's, through oneDNN, within one),
and every op after that inherits the difference.  The L1 loss then flips
the sign of its gradient wherever a prediction lies within that noise of
its target.  So the port's bf16 step is held to JAX's bf16 step at the
scale of JAX's own bf16 rounding, measured in the same test as the distance
from JAX's bf16 step to JAX's f32 step:

* BatchNorm, train mode, bf16 input and scale and bias: the output within
  one bf16 ulp (both compute in f32 from the same bf16 values and round
  once; seen: equal), the f32 running statistics to ``rtol=1e-6``;
* the model's forward in train mode: ``max |port - jax_bf16| <= 0.15`` on
  log-magnitudes of up to ~4 (seen 0.086; JAX's own bf16 vs f32 0.081) and
  the mean within 2x JAX's bf16-vs-f32 mean;
* the loss: ``rtol=2e-2`` (seen 5e-3; JAX bf16 vs f32 6e-3);
* gradients, per tensor, in L2: ``|port - jax_bf16| <= 2 |jax_bf16 -
  jax_f32| + 0.02 |jax_bf16|`` (seen at most 0.71 of that bound; JAX's own
  bf16-vs-f32 distance is 1-37 % of a tensor's norm, and for the conv
  biases in front of BatchNorm, whose exact gradient is zero, the whole
  of it: there both packages' gradients are rounding noise, and the bound
  says the port's noise is no larger than about JAX's);
* after 1 and 3 Adam steps (and the EMA): each parameter within ``2 lr``
  a step of JAX's (Adam moves each entry by about ``lr`` in its gradient's
  sign, which bf16 noise can flip; the f32 tests hold this bound for the
  noise-only conv biases alone), and of all the other parameters' entries
  together at least 90 % within ``0.2 lr`` a step (seen 95.7 % after 3
  steps, 98.2 % after 1, 99.2 % of the EMA); the f32 running statistics
  within ``rtol=2e-3`` plus ``1e-4`` (seen at most 0.49 of that bound: they
  take 1 % of batch statistics a step, over activations that carry bf16
  noise).
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ml_audio_inpainting_tpu.models.cnn_blstm import StackedBLSTMCNN as JaxCNN
from ml_audio_inpainting_tpu.data.multigap import multi_gap_mask as jax_multi_gap_mask
from ml_audio_inpainting_tpu.train import cnn_trainer as jax_trainer
from ml_audio_inpainting_tpu.train import features as jax_features
from ml_audio_inpainting_tpu.train.losses import cnn_gap_l1_loss as jax_l1
from ml_audio_inpainting_tpu.utils.config import Config as JaxConfig
from ml_audio_inpainting_tpu.utils.precision import cast_floating as jax_cast
from ml_audio_inpainting_torch.models.cnn_blstm import FlaxBatchNorm2d
from ml_audio_inpainting_torch.train.cnn_trainer import create_cnn_state, make_cnn_train_step
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.utils.precision import cast_floating
from ml_audio_inpainting_torch.weights import cnn_blstm_flat_variables

SR = 16000
CLIP_S, GAP_S = 1.2, 0.05
N_SAMPLES = int(SR * CLIP_S)
FRAMES = N_SAMPLES // 192 + 1
CLIPS, VARIANTS, N_GAPS = 2, 2, 3
NOISE_GRAD = {f"params/enc_conv{i}/bias" for i in range(3)} | {
    "params/dec_conv0/bias", "params/dec_conv1/bias"}


def _cfg_dict(lr=1e-3):
    return {
        "data": {"max_len_s": CLIP_S, "gap_len_s": GAP_S, "gaps_per_audio": VARIANTS,
                 "train_n_gaps": N_GAPS},
        "model": {"num_lstm_layers": 2, "lstm_hidden_dim": 16, "enc_filters": [4, 8],
                  "dec_filters": [4, 8]},
        "training": {"batch_size": CLIPS, "starter_learning_rate": lr},
    }


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(jnp.asarray(v).astype(jnp.float32))
    return out


def _audio(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(N_SAMPLES) / SR
    clips = [np.sin(2 * np.pi * rng.uniform(100, 300) * t) * (0.5 + 0.5 * np.sin(2 * np.pi * t))
             + 0.05 * rng.standard_normal(N_SAMPLES) for _ in range(CLIPS)]
    return np.stack(clips).astype(np.float32)


def _gaps_of_key(key):
    """The ``(starts, lengths)`` JAX's ``cnn_features`` lays out from ``key``."""
    keys = jax.random.split(key, CLIPS * VARIANTS).reshape(CLIPS, VARIANTS, -1)
    _, starts, lengths = jax.vmap(jax.vmap(lambda k: jax_multi_gap_mask(
        k, N_SAMPLES, N_GAPS, max_gap_ms=GAP_S * 1000.0, sample_rate=SR)))(keys)
    return (torch.tensor(np.asarray(starts), dtype=torch.int64),
            torch.tensor(np.asarray(lengths), dtype=torch.int64))


def _redraw(tree, rng):
    """Every leaf redrawn (as ``tests/test_torch_cnn_train.py`` does): kernels
    from N(0, 1/fan_in), biases and shifts from N(0, 0.1), scales and
    variances around 1."""

    def fill(path, p):
        name = str(path[-1].key)
        if name == "kernel" or name.endswith(("_w_ih", "_w_hh")):
            std = 1.0 / np.sqrt(np.prod(p.shape[:-1]))
        else:
            std = 0.1
        draw = rng.standard_normal(p.shape) * std
        if name in ("scale", "var"):
            draw = 1.0 + np.abs(draw) if name == "var" else 1.0 + draw
        return jnp.asarray(draw, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _states(lr=1e-3, ema=0.0):
    """JAX's state with the Pallas model and the port's, from the same
    redrawn variables."""
    jcfg, cfg = JaxConfig.from_dict(_cfg_dict(lr)), Config.from_dict(_cfg_dict(lr))
    model = JaxCNN(num_lstm_layers=2, lstm_hidden_dim=16, freq_bins=257, enc_filters=(4, 8),
                   dec_filters=(4, 8), use_pallas_lstm=True)
    # Shapes only: every leaf is redrawn below.
    variables = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 257, FRAMES)), train=False))
    rng = np.random.default_rng(0)
    params = _redraw(variables["params"], rng)
    batch_stats = _redraw(variables["batch_stats"], rng)
    jstate = jax_trainer.CNNTrainState.create(
        apply_fn=model.apply, params=params, batch_stats=batch_stats, tx=optax.adam(lr),
        ema_params=jax.tree_util.tree_map(jnp.array, params) if ema > 0 else None)
    flat = flatten({"params": params, "batch_stats": batch_stats})
    return jcfg, cfg, jstate, create_cnn_state(cfg, device="cpu", params=flat, ema=ema)


def _jax_batch(jcfg, audio, key):
    return jax_features.cnn_features(
        jnp.asarray(audio), key, jcfg.data.spectrogram, gap_len_s=GAP_S, sample_rate=SR,
        n_samples=N_SAMPLES, gaps_per_audio=VARIANTS, n_gaps=N_GAPS)


def _jax_loss_and_grads(jstate, batch, dtype):
    """The loss and gradients of JAX's ``loss_fn`` (``cnn_trainer.py:156-171``)
    with ``compute_dtype=dtype`` (None: f32), outside the step."""
    cast = (lambda t: jax_cast(t, dtype)) if dtype is not None else (lambda t: t)

    def loss_fn(params):
        pred, _ = jstate.apply_fn({"params": cast(params), "batch_stats": jstate.batch_stats},
                                  cast(batch["log_gap"]), train=True, mutable=["batch_stats"])
        return jax_l1(pred.astype(jnp.float32), batch["target_mag"], batch["gap_mask"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jstate.params)
    return float(loss), flatten({"params": grads})


@pytest.mark.parametrize("updates", [1, 2])
def test_batchnorm_bf16_train_mode_matches_flax(updates):
    """flax's ``BatchNorm`` on bf16 input with bf16 scale and bias and f32
    running statistics, as the JAX bf16 step runs it."""
    import flax.linen as fnn

    rng = np.random.default_rng(10 + updates)
    x = jnp.asarray(rng.standard_normal((3, 5, 7, 4)) * 2 + 1, jnp.bfloat16)  # NHWC
    scale = jnp.asarray(rng.uniform(0.5, 1.5, 4), jnp.bfloat16)
    bias = jnp.asarray(rng.standard_normal(4), jnp.bfloat16)
    bn = fnn.BatchNorm(use_running_average=False)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": jnp.zeros(4), "var": jnp.ones(4)}}
    port = FlaxBatchNorm2d(4).train()
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16).permute(0, 3, 1, 2)
    params = {"weight": torch.tensor(np.asarray(scale.astype(jnp.float32))).to(torch.bfloat16),
              "bias": torch.tensor(np.asarray(bias.astype(jnp.float32))).to(torch.bfloat16)}
    for _ in range(updates):
        want, upd = bn.apply(variables, x, mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        got = torch.func.functional_call(port, params, (xt,))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert port.running_mean.dtype == port.running_var.dtype == torch.float32
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().permute(0, 2, 3, 1).numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(port, ours).numpy(),
                                   np.asarray(variables["batch_stats"][theirs]),
                                   rtol=1e-6, atol=1e-7)


def test_model_bf16_forward_matches_jax():
    """The whole model in train mode on bf16 casts of the parameters and of
    ``log_gap``, as the bf16 step runs its forward pass."""
    jcfg, _, jstate, state = _states()
    batch = _jax_batch(jcfg, _audio(1), jax.random.PRNGKey(11))
    apply = jax.jit(lambda v, x: jstate.apply_fn(v, x, train=True, mutable=["batch_stats"])[0])
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    want = apply(jax_cast(variables, jnp.bfloat16) | {"batch_stats": jstate.batch_stats},
                 batch["log_gap"].astype(jnp.bfloat16))
    want32 = apply(variables, batch["log_gap"])
    params = cast_floating(dict(state.model.named_parameters()), torch.bfloat16)
    with torch.no_grad():
        got = torch.func.functional_call(
            state.model, params, (torch.tensor(np.asarray(batch["log_gap"])).to(torch.bfloat16),))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    got, want, want32 = got.float().numpy(), np.asarray(want.astype(jnp.float32)), np.asarray(want32)
    err = np.abs(got - want)
    assert err.max() <= 0.15
    assert err.mean() <= 2 * np.abs(want - want32).mean()


def test_bf16_step_loss_and_gradients_match_jax():
    jcfg, cfg, jstate, state = _states()
    audio = _audio(1)
    key = jax.random.PRNGKey(11)
    batch = _jax_batch(jcfg, audio, key)
    want_loss, want = _jax_loss_and_grads(jstate, batch, jnp.bfloat16)
    _, want32 = _jax_loss_and_grads(jstate, batch, None)

    dtypes = set()
    hooks = [m.register_forward_hook(lambda m, i, o: dtypes.add(o.dtype))
             for m in state.model.children()]
    _, metrics = make_cnn_train_step(cfg, compute_dtype=torch.bfloat16)(
        state, torch.tensor(audio), *_gaps_of_key(key))
    for hook in hooks:
        hook.remove()
    assert dtypes == {torch.bfloat16}  # every layer ran in bf16
    assert metrics["loss"].dtype == torch.float32
    np.testing.assert_allclose(metrics["loss"].item(), want_loss, rtol=2e-2)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    got = cnn_blstm_flat_variables(grads)
    assert set(got) == set(want)
    for k in sorted(want):
        err = np.linalg.norm(got[k] - want[k])
        bound = 2 * np.linalg.norm(want[k] - want32[k]) + 0.02 * np.linalg.norm(want[k])
        assert err <= bound, f"{k}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("steps,ema", [(1, 0.0), (3, 0.0), (3, 0.9)],
                         ids=["1-step", "3-steps", "3-steps-ema"])
def test_bf16_train_steps_match_jax(steps, ema):
    """Parameters, f32 running statistics (and the EMA) after ``steps``
    bf16 steps of each package from the same variables and gaps."""
    lr = 1e-3
    jcfg, cfg, jstate, state = _states(lr, ema)
    jstep = jax_trainer.make_cnn_train_step(jcfg, ema=ema, compute_dtype=jnp.bfloat16)
    step = make_cnn_train_step(cfg, ema=ema, compute_dtype=torch.bfloat16)
    for i in range(steps):
        audio = _audio(20 + i)
        key = jax.random.PRNGKey(200 + i)
        jstate, jm = jstep(jstate, jnp.asarray(audio), key)
        state, m = step(state, torch.tensor(audio), *_gaps_of_key(key))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=2e-2)
    assert state.step == steps
    got = cnn_blstm_flat_variables(state.model.state_dict())
    want = flatten({"params": jstate.params, "batch_stats": jstate.batch_stats})
    pairs = [(got, want)]
    if ema:
        pairs.append((cnn_blstm_flat_variables(state.ema_params), flatten({"params": jstate.ema_params})))
    for ours, theirs in pairs:
        assert set(ours) == set(theirs)
        close = []
        for k in sorted(theirs):
            assert ours[k].dtype == np.float32, k
            err = np.abs(ours[k] - theirs[k])
            if k.startswith("batch_stats/"):
                np.testing.assert_allclose(ours[k], theirs[k], rtol=2e-3, atol=1e-4, err_msg=k)
            else:
                assert err.max() <= 1e-6 + 2 * lr * steps, k
                if k not in NOISE_GRAD:
                    close.append((err <= 0.2 * lr * steps).ravel())
        assert np.concatenate(close).mean() >= 0.9


def test_f32_step_with_three_gaps_matches_jax():
    """The f32 step with three gaps a clip against JAX's f32 step (the
    Pallas model): the loss to ``rtol=1e-5`` (as in
    ``tests/test_torch_cnn_train.py``); each gradient within ``1e-4`` of the
    model's largest gradient entry (seen 1.9e-5) and within ``2e-3`` of its
    own largest entry (seen 7.9e-4, on ``enc_bn1/bias``: a BatchNorm bias's
    gradient is a sum of terms of both signs over every position, and at
    1.2 s it has 2.4x the terms it has at the 0.5 s of the f32 tests; the
    conv biases in front of BatchNorm, whose exact gradient is zero, are
    held to the first bound alone)."""
    jcfg, cfg, jstate, state = _states()
    audio = _audio(2)
    key = jax.random.PRNGKey(12)
    want_loss, want = _jax_loss_and_grads(jstate, _jax_batch(jcfg, audio, key), None)
    _, metrics = make_cnn_train_step(cfg)(state, torch.tensor(audio), *_gaps_of_key(key))
    np.testing.assert_allclose(metrics["loss"].item(), want_loss, rtol=1e-5)
    got = cnn_blstm_flat_variables({n: p.grad for n, p in state.model.named_parameters()})
    g_max = max(np.abs(v).max() for v in want.values())
    for k in sorted(want):
        err = np.abs(got[k] - want[k]).max()
        assert err <= 1e-4 * g_max, k
        assert k in NOISE_GRAD or err <= 2e-3 * np.abs(want[k]).max(), k

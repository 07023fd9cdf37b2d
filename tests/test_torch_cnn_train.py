"""CNN+BiLSTM training in the port (``ml_audio_inpainting_torch/train/``,
``models/cnn_blstm.py`` in train mode, ``weights.py``'s inverse mapping)
against the JAX package on the CPU.

The JAX step draws its gap positions from a ``jax.random`` key; these tests
derive the same positions from the key's splits (as
``features.cnn_features`` -> ``random_gap_mask`` does) and hand them to the
port, so both packages see the same batch.  Initial weights come from the
JAX ``create_cnn_state`` through ``cnn_blstm_state_dict``, with every leaf
redrawn from a seeded numpy generator (kernels N(0, 1/fan_in), the rest
around their init values): JAX's own draw puts U[0, 2/sqrt(H)) weights on
the 2056 inputs of BiLSTM layer 0, which saturates its gates, and then every
gradient below layer 1 is exactly zero in both packages and would test
nothing.

Tolerances, on a narrow model (enc [4, 8], hidden 16, 2 layers) and 0.5 s
clips (257 x 42), every sum in another order:

* features: ``log_gap`` atol 1e-4 plus rtol 2e-4 (log10 of STFT bins that
  differ by FFT rounding; the smallest bins, whose log is largest in
  magnitude, carry the largest relative rounding), masks exact, ``target_mag`` atol 1e-4 on bins
  up to ~1e2 (as ``tests/test_torch_dsp.py``);
* loss: rtol 1e-5 (a sum of ~10^3 positive terms);
* gradients: per tensor, ``max|port - jax| <= 1e-4 * max|jax|``;
* parameters after Adam steps: atol 1e-6 plus 2e-2 of the step's learning
  rate per step -- Adam divides each gradient by its own running RMS, so a
  gradient that is pure rounding noise in both packages (the conv biases in
  front of BatchNorm, whose exact gradient is zero) can move its parameter
  by up to +-lr in either; those tensors are held to 2 lr per step and are
  listed in ``NOISE_GRAD``;
* BatchNorm running statistics: rtol 1e-5, plus atol 1e-6 + 4e-2 of the
  summed learning rates -- the noisy conv bias in front of a BatchNorm
  shifts its batch mean by up to 2 lr a step, and the running mean takes 1 %
  of that each step (at most 0.06 lr after 3 steps at a fixed lr, seen
  0.057 lr).
"""

import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.models.cnn_blstm import StackedBLSTMCNN as JaxCNN
from ml_audio_inpainting_tpu.ops import gaps as jax_gaps
from ml_audio_inpainting_tpu.train import cnn_trainer as jax_trainer
from ml_audio_inpainting_tpu.train import features as jax_features
from ml_audio_inpainting_tpu.train.checkpoints import export_params_npz as jax_export_npz
from ml_audio_inpainting_tpu.train.checkpoints import load_params_npz as jax_load_npz
from ml_audio_inpainting_tpu.train.losses import cnn_gap_l1_loss as jax_l1
from ml_audio_inpainting_tpu.utils.config import Config as JaxConfig
from ml_audio_inpainting_torch.models.cnn_blstm import FlaxBatchNorm2d, StackedBLSTMCNN
from ml_audio_inpainting_torch.ops.gaps import random_gap_mask
from ml_audio_inpainting_torch.train.checkpoints import export_params_npz
from ml_audio_inpainting_torch.train.cnn_trainer import (
    create_cnn_state,
    make_cnn_eval_step,
    make_cnn_train_step,
)
from ml_audio_inpainting_torch.train.features import cnn_features
from ml_audio_inpainting_torch.train.losses import cnn_gap_l1_loss
from ml_audio_inpainting_torch.train.recipe import gap_starts, live_bilstm, recipe_config
from ml_audio_inpainting_torch.utils.config import Config, TrainingConfig
from ml_audio_inpainting_torch.weights import (
    cnn_blstm_flat_variables,
    cnn_blstm_state_dict,
    load_params_npz,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "results", "checkpoints", "cnn_blstm_formant_v2_r2.npz")
SR = 16000
CLIP_S, GAP_S = 0.5, 0.05
N_SAMPLES = int(SR * CLIP_S)
CLIPS, VARIANTS = 2, 2
# Conv biases in front of BatchNorm: the batch mean removes them, so their
# exact gradient is zero and what both packages compute is rounding noise.
NOISE_GRAD = {f"params/enc_conv{i}/bias" for i in range(3)} | {
    "params/dec_conv0/bias", "params/dec_conv1/bias"}


def _cfg_dict(lr=1e-3, lr_decay=1.0):
    return {
        "data": {"max_len_s": CLIP_S, "gap_len_s": GAP_S, "gaps_per_audio": VARIANTS},
        "model": {"num_lstm_layers": 2, "lstm_hidden_dim": 16, "enc_filters": [4, 8],
                  "dec_filters": [4, 8]},
        "training": {"batch_size": CLIPS, "starter_learning_rate": lr, "lr_decay": lr_decay},
    }


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _audio(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(N_SAMPLES) / SR
    clips = [np.sin(2 * np.pi * rng.uniform(100, 300) * t) * (0.5 + 0.5 * np.sin(2 * np.pi * t))
             + 0.05 * rng.standard_normal(N_SAMPLES) for _ in range(CLIPS)]
    return np.stack(clips).astype(np.float32)


def _starts_of_key(key, clips=CLIPS, variants=VARIANTS, n=N_SAMPLES, gap_s=GAP_S):
    """The gap starts ``features.cnn_features`` draws from ``key``: one
    ``random_gap_mask`` per split, clips by variants."""
    keys = jax.random.split(key, clips * variants).reshape(clips, variants, -1)
    starts = jax.vmap(jax.vmap(
        lambda k: jax_gaps.random_gap_mask(k, n, gap_s, SR)[1][0]))(keys)
    return torch.tensor(np.asarray(starts), dtype=torch.int64)


def _jax_loss_and_grads(jcfg, state, audio, key):
    """The loss and gradients of ``cnn_trainer.make_cnn_train_step``'s
    ``loss_fn``, outside the step (which returns neither)."""
    batch = jax_features.cnn_features(
        jnp.asarray(audio), key, jcfg.data.spectrogram, gap_len_s=jcfg.data.gap_len_s,
        sample_rate=SR, n_samples=N_SAMPLES, gaps_per_audio=VARIANTS)

    def loss_fn(params):
        pred, _ = state.apply_fn({"params": params, "batch_stats": state.batch_stats},
                                 batch["log_gap"], train=True, mutable=["batch_stats"])
        return jax_l1(pred, batch["target_mag"], batch["gap_mask"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    return float(loss), flatten({"params": grads})


def _redraw(tree, rng):
    """Every leaf of a flax variables tree redrawn: kernels (conv, dense and
    BiLSTM) from N(0, 1/fan_in), biases and BatchNorm shifts from N(0, 0.1),
    scales and variances around 1."""

    def fill(path, p):
        name = str(path[-1].key)
        if name in ("kernel",) or name.endswith(("_w_ih", "_w_hh")):
            std = 1.0 / np.sqrt(np.prod(p.shape[:-1]))
        else:
            std = 0.1
        draw = rng.standard_normal(p.shape) * std
        if name in ("scale", "var"):
            draw = 1.0 + np.abs(draw) if name == "var" else 1.0 + draw
        return jnp.asarray(draw, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _states(lr=1e-3, lr_decay=1.0, ema=0.0):
    jcfg = JaxConfig.from_dict(_cfg_dict(lr, lr_decay))
    cfg = Config.from_dict(_cfg_dict(lr, lr_decay))
    jstate = jax_trainer.create_cnn_state(jcfg, jax.random.PRNGKey(0), ema=ema)
    rng = np.random.default_rng(0)
    params = _redraw(jstate.params, rng)
    jstate = jstate.replace(
        params=params, batch_stats=_redraw(jstate.batch_stats, rng),
        opt_state=jstate.tx.init(params),
        ema_params=jax.tree_util.tree_map(jnp.array, params) if ema > 0 else None)
    flat = flatten({"params": jstate.params, "batch_stats": jstate.batch_stats})
    state = create_cnn_state(cfg, device="cpu", params=flat, ema=ema)
    return jcfg, cfg, jstate, state


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for k in sorted(want):
        scale = np.max(np.abs(want[k]))
        err = np.max(np.abs(got[k] - want[k]))
        bound = 1e-4 * max(scale, 1e-30) if k not in NOISE_GRAD else 1e-4 * max(
            np.max(np.abs(v)) for v in want.values())
        assert err <= bound, f"{k}: max err {err:.3e} > {bound:.3e} (max |grad| {scale:.3e})"


def _assert_variables_close(got, want, lr_total):
    assert set(got) == set(want)
    for k in sorted(want):
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6 + 4e-2 * lr_total,
                                       err_msg=k)
        else:
            atol = 1e-6 + (2.0 if k in NOISE_GRAD else 2e-2) * lr_total
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)


def test_cnn_features_match_jax():
    spec_cfg = JaxConfig().data.spectrogram
    audio = _audio(0)
    key = jax.random.PRNGKey(7)
    want = jax_features.cnn_features(jnp.asarray(audio), key, spec_cfg, gap_len_s=GAP_S,
                                     sample_rate=SR, n_samples=N_SAMPLES,
                                     gaps_per_audio=3)
    starts = _starts_of_key(key, variants=3)
    assert starts.shape == (CLIPS, 3) and len(set(starts.flatten().tolist())) > 1
    got = cnn_features(torch.tensor(audio), starts, Config().data.spectrogram, gap_len_s=GAP_S,
                       sample_rate=SR)
    assert set(got) == {"log_gap", "gap_mask", "target_mag"}
    for k in got:
        assert got[k].shape == want[k].shape == (CLIPS * 3, 257, 42)
    np.testing.assert_array_equal(got["gap_mask"].numpy(), np.asarray(want["gap_mask"]))
    np.testing.assert_allclose(got["log_gap"].numpy(), np.asarray(want["log_gap"]),
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(got["target_mag"].numpy(), np.asarray(want["target_mag"]),
                               rtol=0, atol=1e-4)


def test_cnn_gap_l1_loss_matches_jax():
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((3, 17, 9)).astype(np.float32)
    target = np.abs(rng.standard_normal((3, 17, 9))).astype(np.float32)
    mask = (rng.uniform(size=(3, 17, 9)) < 0.3).astype(np.float32)
    want = float(jax_l1(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask)))
    got = cnn_gap_l1_loss(*(torch.tensor(a) for a in (pred, target, mask))).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("momentum_steps", [1, 2])
def test_batchnorm_train_mode_matches_flax(momentum_steps):
    """Output and running statistics of flax's train-mode BatchNorm."""
    import flax.linen as fnn

    rng = np.random.default_rng(momentum_steps)
    x = (rng.standard_normal((3, 5, 7, 4)) * 2 + 1).astype(np.float32)  # NHWC
    scale = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(4), "var": jnp.ones(4)}}
    port = FlaxBatchNorm2d(4).train()
    with torch.no_grad():
        port.weight.copy_(torch.tensor(scale))
        port.bias.copy_(torch.tensor(bias))
    for _ in range(momentum_steps):
        want, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        got = port(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(port, ours).numpy(),
                                   np.asarray(variables["batch_stats"][theirs]),
                                   rtol=1e-6, atol=1e-7)


def test_one_step_loss_and_gradients_match_jax():
    jcfg, cfg, jstate, state = _states()
    audio = _audio(1)
    key = jax.random.PRNGKey(11)
    want_loss, want_grads = _jax_loss_and_grads(jcfg, jstate, audio, key)
    _, metrics = make_cnn_train_step(cfg)(state, torch.tensor(audio), _starts_of_key(key))
    np.testing.assert_allclose(metrics["loss"].item(), want_loss, rtol=1e-5)
    got = cnn_blstm_flat_variables(
        {name: p.grad for name, p in state.model.named_parameters()})
    _assert_grads_close(got, want_grads)


@pytest.mark.parametrize(
    "steps,lr_decay,ema",
    [(1, 1.0, 0.0), (3, 1.0, 0.0), (3, 0.5, 0.0), (3, 1.0, 0.9)],
    ids=["1-step", "3-steps", "3-steps-lr-decay", "3-steps-ema"],
)
def test_train_steps_match_jax(steps, lr_decay, ema):
    """Parameters and ``batch_stats`` (and the EMA) after ``steps`` steps of
    each package's train step from the same variables and gap positions."""
    lr = 1e-3
    jcfg, cfg, jstate, state = _states(lr, lr_decay, ema)
    jstep = jax_trainer.make_cnn_train_step(jcfg, ema=ema)
    step = make_cnn_train_step(cfg, ema=ema)
    lr_total = 0.0
    for i in range(steps):
        audio = _audio(10 + i)
        key = jax.random.PRNGKey(100 + i)
        jstate, jm = jstep(jstate, jnp.asarray(audio), key)
        state, m = step(state, torch.tensor(audio), _starts_of_key(key))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        lr_total += lr * lr_decay**i
    assert state.step == steps
    np.testing.assert_allclose(state.optimizer.param_groups[0]["lr"], lr * lr_decay**steps)
    want = flatten({"params": jstate.params, "batch_stats": jstate.batch_stats})
    _assert_variables_close(cnn_blstm_flat_variables(state.model.state_dict()), want, lr_total)
    if ema:
        got_ema = cnn_blstm_flat_variables(state.ema_params)
        want_ema = flatten({"params": jstate.ema_params})
        _assert_variables_close(got_ema, want_ema, lr_total)
        assert not np.allclose(got_ema["params/lstm/l0_fwd_w_hh"],
                               cnn_blstm_flat_variables(state.model.state_dict())[
                                   "params/lstm/l0_fwd_w_hh"])


def test_eval_step_matches_jax():
    jcfg, cfg, jstate, state = _states()
    audio = _audio(5)
    key = jax.random.PRNGKey(5)
    want = float(jax_trainer.make_cnn_eval_step(jcfg)(jstate, jnp.asarray(audio), key)["loss"])
    got = make_cnn_eval_step(cfg)(state, torch.tensor(audio), _starts_of_key(key))["loss"]
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    assert not state.model.training


def test_later_slice_options_raise():
    """f16 is refused; ``phase_mode`` (ported: ``tests/test_torch_phase_train.py``)
    is refused only where it cannot run: on the 1-channel model, with
    multi-gap features, and ``phase_anchor`` without it."""
    cfg = Config.from_dict(_cfg_dict())
    with pytest.raises(ValueError, match="compute_dtype"):  # f32 and bf16 only
        make_cnn_train_step(cfg, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="in_channels"):
        make_cnn_train_step(cfg, phase_mode=True)
    with pytest.raises(ValueError, match="phase_anchor"):
        make_cnn_eval_step(cfg, phase_anchor=True)
    cfg.model.cnn_blstm.in_channels = 2
    make_cnn_train_step(cfg, phase_mode=True, phase_anchor=True)
    make_cnn_eval_step(cfg, phase_mode=True)
    cfg.data.train_n_gaps = 3
    with pytest.raises(ValueError, match="single-gap"):
        make_cnn_train_step(cfg, phase_mode=True)


def test_fresh_init_follows_the_jax_distributions():
    """BiLSTM weights in U[0, 2/sqrt(H)), biases zero; conv and dense kernels
    lecun-normal (truncated at 2 std, variance 1/fan_in), biases zero;
    BatchNorm at scale 1, bias 0, mean 0, var 1.  Seeded: the same seed
    gives the same weights."""
    cfg = Config.from_dict(_cfg_dict())
    state = create_cnn_state(cfg, device="cpu", seed=3)
    again = create_cnn_state(cfg, device="cpu", seed=3)
    H = 16
    flat = cnn_blstm_flat_variables(state.model.state_dict())
    for k, v in flat.items():
        np.testing.assert_array_equal(v, cnn_blstm_flat_variables(again.model.state_dict())[k])
        leaf = k.rsplit("/", 1)[1]
        if k.startswith("params/lstm/"):
            if leaf.endswith("_b"):
                assert not v.any(), k
            else:
                assert v.min() >= 0 and v.max() < 2 / np.sqrt(H) and v.std() > 0.1 / np.sqrt(H), k
        elif leaf == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            std = 1 / np.sqrt(fan_in) / 0.87962566103423978
            assert np.abs(v).max() <= 2 * std + 1e-7, k
            if v.size >= 1000:
                assert abs(v.std() * np.sqrt(fan_in) - 1) < 0.1, k
        elif leaf in ("bias", "mean"):
            assert not v.any(), k
        else:
            assert leaf in ("scale", "var") and (v == 1).all(), k
    # The same keys and shapes as the JAX init.
    jstate = jax_trainer.create_cnn_state(JaxConfig.from_dict(_cfg_dict()), jax.random.PRNGKey(0))
    want = flatten({"params": jstate.params, "batch_stats": jstate.batch_stats})
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in want.items()}


def test_export_round_trips_through_jax(tmp_path):
    """Port -> npz -> JAX ``load_params_npz`` -> the same model output as the
    port; and JAX ``export_params_npz`` -> the port's loader, back."""
    cfg = Config.from_dict(_cfg_dict())
    state = create_cnn_state(cfg, device="cpu", seed=1)
    step = make_cnn_train_step(cfg)
    state, _ = step(state, torch.tensor(_audio(2)), torch.tensor([[1000, 4000], [0, 7200]]))
    model = state.model.eval()
    path = tmp_path / "port.npz"
    export_params_npz(path, model)
    jvars = jax_load_npz(path)
    x = np.random.default_rng(0).standard_normal((1, 257, 12)).astype(np.float32)
    jmodel = JaxCNN(num_lstm_layers=2, lstm_hidden_dim=16, freq_bins=257,
                    enc_filters=(4, 8), dec_filters=(4, 8))
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x), train=False))
    f16 = StackedBLSTMCNN(num_lstm_layers=2, lstm_hidden_dim=16, enc_filters=(4, 8),
                          dec_filters=(4, 8)).eval()
    f16.load_state_dict(cnn_blstm_state_dict(load_params_npz(path)))
    with torch.no_grad():
        got = f16(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    saved = np.load(path)
    assert all(saved[k].dtype == np.float16 for k in saved.files)
    # f16 rounding of the weights: the f32 model's output moves by ~1e-3.
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.tensor(x)).numpy(), want, rtol=0, atol=2e-2)

    back = tmp_path / "jax.npz"
    jax_export_npz(back, jvars, dtype=None)
    again = load_params_npz(back)
    np.testing.assert_equal(again, cnn_blstm_flat_variables(f16.state_dict()))


def test_training_config_defaults_and_parsing(tmp_path):
    jt = JaxConfig().training
    for name in ("batch_size", "optimizer_type", "starter_learning_rate", "lr_decay",
                 "max_n_epochs"):
        assert getattr(TrainingConfig(), name) == getattr(jt, name), name
    path = tmp_path / "c.yaml"
    path.write_text(open(os.path.join(REPO, "configs", "cnn_blstm.yaml")).read())
    cfg = Config.from_yaml(path)
    assert (cfg.training.batch_size, cfg.training.starter_learning_rate) == (1, 1e-4)
    assert cfg.data.gaps_per_audio == 25


def test_recipe_matches_the_yaml_config():
    """The recipe the card runs (``train/recipe.py``, built in Python) is
    ``configs/cnn_blstm.yaml``'s data, model and training sections, but for
    where the LibriSpeech files lie and how many to read: the card trains on
    seeded clips."""
    want = Config.from_yaml(os.path.join(REPO, "configs", "cnn_blstm.yaml")).to_dict()
    got = recipe_config().to_dict()
    for d in (want, got):
        for key in ("root_path", "n_files"):
            d["data"].pop(key)
    for section in ("data", "model", "training"):
        assert got[section] == want[section], section


def test_recipe_gap_starts_and_live_bilstm():
    cfg = recipe_config()
    a = gap_starts(torch.Generator().manual_seed(5), cfg, 2, 25)
    b = gap_starts(torch.Generator().manual_seed(5), cfg, 2, 25)
    assert a.shape == (2, 25) and a.dtype == torch.int64 and torch.equal(a, b)
    assert ((a >= 0) & (a + round(cfg.data.gap_len_s * cfg.data.sample_rate)
                        <= cfg.data.max_samples)).all()
    flat = load_params_npz(CKPT)
    live = live_bilstm(flat, seed=6)
    assert live.keys() == flat.keys()
    for key, value in flat.items():
        redrawn = key.startswith("params/lstm/") and not key.endswith("_b")
        assert np.array_equal(live[key], value) != redrawn, key
        if redrawn:
            assert np.abs(live[key]).max() <= value.shape[0] ** -0.5


def test_random_gap_mask_edge_cases():
    g = torch.Generator().manual_seed(0)
    mask, (s, e) = random_gap_mask(g, 100, 0.0)
    assert mask.eq(1).all() and (s.item(), e.item()) == (0, 0)
    mask, (s, e) = random_gap_mask(g, 100, 200 / SR)
    assert mask.eq(0).all() and (s.item(), e.item()) == (0, 100)
    mask, (s, e) = random_gap_mask(g, 100, 10 / SR, gap_start_s=30 / SR)
    assert (s.item(), e.item()) == (30, 40) and mask[30:40].eq(0).all() and mask.sum() == 90
    seen = set()
    for _ in range(300):  # start uniform over [0, audio_len - gap_len] inclusive
        mask, (s, e) = random_gap_mask(g, 5, 3 / SR)
        assert e - s == 3 and mask.sum() == 2 and mask[s:e].eq(0).all()
        seen.add(s.item())
    assert seen == {0, 1, 2}
    a, _ = random_gap_mask(torch.Generator().manual_seed(9), 1000, 0.001)
    b, _ = random_gap_mask(torch.Generator().manual_seed(9), 1000, 0.001)
    assert torch.equal(a, b)

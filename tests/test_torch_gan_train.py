"""GAN training in the port (``train/gan_trainer.py``) against the JAX
package's (``train/gan_trainer.py``) on the CPU, at
``tests/test_gan.py::tiny_gan_config``'s sizes (1 s clips, G enc (8,7,2),
(16,5,2), (16,3,2), dec (16,3,1), (8,3,1); D (8,2), (16,2)).

Both packages start from the JAX ``create_gan_states`` weights, carried
across as flat flax variables, and see the same batch: the JAX step draws
its gaps from a key, and the port is handed the positions that key gives
(``test_torch_gan_features.gaps_of_key``).  JAX's step-0 gradients come
from a replica of its step's two loss functions (checked against the
step's own losses).

Tolerances (f32 unless stated; every sum in another order):

* losses: rtol 1e-5 at step 0 and 1e-4 after it (the parameters then
  differ a little, below; measured 5e-7, 2.1e-6, 1.5e-5);
* step-0 gradients: per tensor within 1e-4 of its largest entry;
* parameters after Adam steps, compared with the size of their updates,
  not with their values: Adam's first update is about ``lr * sign(g)``, so
  an entry whose gradient is rounding noise near zero can move by +-lr in
  either package.  Each entry within 2 lr a step (the sign-flip bound
  ``tests/test_gan.py`` uses), and all but 1 + 0.1 % of a tensor's entries
  within 0.05 lr a step (plus 1e-7); measured: one entry of 3200 in G's
  enc1 kernel at 1.35 lr after 3 steps, every other within 1.2e-3 lr;
* G's running statistics, D's ``u`` and ``sigma``, after the steps: 1e-5
  absolute (values of order 1, measured <= 1.3e-6);
* the EMA: the same bounds as the parameters;
* ``remat`` against the plain step and ``fused_g_forward`` against the
  default, in the port: losses rtol 1e-6, parameters and running
  statistics 1e-6 (the same computation; the fused G gradient is the same
  chain rule in another order);
* with VGG on (B=1, JAX's seed-42 VGG carried across): losses rtol 1e-4,
  gradients within 1e-3 of each tensor's largest entry (the VGG input's
  antialiased resize differs by ~5e-5 between the packages,
  ``tests/test_torch_vgg.py``, and the style term weighs 500);
* bf16 against JAX's bf16 step (each rounds to bf16 in its own places):
  losses rtol 5e-3 (measured 7e-4), each gradient within 0.1 of its L2
  norm (measured <= 0.042), D's ``u`` and ``sigma`` within 2e-2 (measured
  3.6e-3, and one bf16 ulp of sigma, 7.8e-3); masters, Adam's moments,
  running statistics and EMA f32.  The convolutions' bias gradients are
  held against the port's f32 step instead: JAX's bf16 step sums them far
  from its own f32 gradients (0.25 to 1.0 of their norm, the final conv's
  exactly 0), the port's lie within 0.041 of f32.
"""

import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_gan import tiny_gan_config
from test_torch_gan_features import gaps_of_key

from ml_audio_inpainting_tpu.models import vgg as jax_vgg
from ml_audio_inpainting_tpu.train import features as jax_features
from ml_audio_inpainting_tpu.train import gan_trainer as jax_trainer
from ml_audio_inpainting_tpu.train.losses import discriminator_loss as jax_d_loss
from ml_audio_inpainting_tpu.train.losses import generator_losses as jax_g_losses
from ml_audio_inpainting_tpu.utils.precision import cast_floating as jax_cast
from ml_audio_inpainting_torch.models.vgg import VGG19Features
from ml_audio_inpainting_torch.ops.pcm import to_pcm16
from ml_audio_inpainting_torch.runtime.serve import make_gan_runner
from ml_audio_inpainting_torch.runtime.transport import composite_gap_patch
from ml_audio_inpainting_torch.train.checkpoints import export_params_npz
from ml_audio_inpainting_torch.train.gan_trainer import (
    create_gan_states,
    make_gan_eval_step,
    make_gan_train_step,
)
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.weights import (
    discriminator_flat_variables,
    load_params_npz,
    pconv_unet_flat_variables,
    vgg19_state_dict,
)

SR, N = 16000, 16000
LR = 2e-4
STEPS = 3
EMA = 0.5
PARAM_LR_SHARE = 0.05
STATE_ATOL = 1e-5
BF16_GRAD_SHARE = 0.1


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flatten(v, key) if isinstance(v, Mapping) else {key: np.asarray(v)})
    return out


def port_config(jcfg) -> Config:
    return Config.from_dict(jcfg.to_dict())


def _audio(clips=2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / SR
    return np.stack([(0.5 * np.sin(2 * np.pi * rng.uniform(100, 300) * t)
                      + 0.25 * np.sin(2 * np.pi * rng.uniform(600, 1200) * t))
                     * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1, 3) * t))
                     + 0.02 * rng.standard_normal(N) for _ in range(clips)]).astype(np.float32)


def _keys():
    return [jax.random.PRNGKey(100 + i) for i in range(STEPS)]


def _flats(g_state, d_state):
    g = flatten({"params": g_state.params, "batch_stats": g_state.batch_stats})
    d = flatten({"params": d_state.params, "batch_stats": d_state.batch_stats})
    return g, d


def _port_states(jcfg, g_flat, d_flat, ema=0.0):
    return create_gan_states(port_config(jcfg), device="cpu", params=g_flat, d_params=d_flat,
                             g_ema=ema)


def _port_flats(g, d):
    return pconv_unet_flat_variables(g.model.state_dict()), discriminator_flat_variables(
        d.model.state_dict())


def _grads(g, d):
    return (pconv_unet_flat_variables({n: p.grad for n, p in g.model.named_parameters()}),
            discriminator_flat_variables({n: p.grad for n, p in d.model.named_parameters()}))


def jax_step0_grads(jcfg, g_state, d_state, d_after, audio, key, vgg=None, dtype=None):
    """JAX's step-0 gradients, from a replica of ``make_gan_train_step``'s
    D and G loss functions (``gan_trainer.py:235-321``, jitted) and the D
    state the real step produced; returns (G grads, D grads, G losses, D
    losses), the gradients as flat flax keys."""
    g_grads, d_grads, g_losses, d_losses = jax.jit(
        lambda *a: _replica_grads(jcfg, *a, vgg=vgg, dtype=dtype))(
        g_state, d_state, d_after, audio, key)
    return flatten({"params": g_grads}), flatten({"params": d_grads}), g_losses, d_losses


def _replica_grads(jcfg, g_state, d_state, d_after, audio, key, vgg=None, dtype=None):
    cast = (lambda t: jax_cast(t, dtype)) if dtype is not None else (lambda t: t)
    batch = jax_features.gan_features(
        audio, key, jcfg.data.spectrogram, gap_len_s=jcfg.data.gap_len_s,
        sample_rate=jcfg.data.sample_rate, n_samples=jcfg.data.max_samples,
        n_gaps=jcfg.data.train_n_gaps)
    orig, imp, mask = batch["original_magnitude"], batch["impaired_magnitude"], batch["mask"]

    def g_apply(p):
        return g_state.apply_fn({"params": cast(p), "batch_stats": g_state.batch_stats},
                                cast(imp), cast(mask), train=True, mutable=["batch_stats"])[0]

    fake = jax.lax.stop_gradient(g_apply(g_state.params))

    def d_loss(p):
        r, u1 = d_state.apply_fn({"params": cast(p), "batch_stats": cast(d_state.batch_stats)},
                                 cast(orig), train=True, mutable=["batch_stats"])
        f, _ = d_state.apply_fn({"params": cast(p), **u1}, fake, train=True,
                                mutable=["batch_stats"])
        losses = jax_d_loss(r.astype(jnp.float32), f.astype(jnp.float32))
        return losses["d_total"], losses

    t = jcfg.training
    lambdas = {k: getattr(t, k) for k in (
        "lambda_adv", "lambda_l1_valid", "lambda_l1_hole", "lambda_mag_weighted",
        "lambda_vgg_perceptual", "lambda_vgg_style")}

    def g_loss(p):
        f = g_apply(p)
        logits = d_after.apply_fn({"params": cast(d_after.params),
                                   "batch_stats": cast(d_after.batch_stats)}, f, train=False)
        vl = None
        if vgg is not None:
            vl = jax_vgg.vgg_perceptual_style_losses(vgg[0], cast(vgg[1]), f, cast(orig))
        losses = jax_g_losses(f.astype(jnp.float32), orig, mask, logits.astype(jnp.float32),
                              lambdas, vl)
        return losses["g_total"], losses

    d_grads, d_losses = jax.grad(d_loss, has_aux=True)(d_state.params)
    g_grads, g_losses = jax.grad(g_loss, has_aux=True)(g_state.params)
    return g_grads, d_grads, g_losses, d_losses


def jax_states(jcfg, seed=0, ema=0.0):
    """``create_gan_states`` under ``jax.jit`` (the same values; flax's
    eager init of the generator at 257 x 126 takes ~20 s on the CPU)."""
    return jax.jit(lambda k: jax_trainer.create_gan_states(jcfg, k, g_ema=ema))(
        jax.random.PRNGKey(seed))


def _check_grads(got, want, rel, label):
    assert set(got) == set(want), label
    for key, value in want.items():
        scale = np.abs(value).max()
        err = np.abs(got[key] - value).max()
        assert err <= rel * scale, f"{label} {key}: {err} > {rel} x {scale}"


def _check_params(got, want, steps, label):
    for key, value in want.items():
        err = np.abs(got[key] - value)
        if not key.startswith("params/"):
            assert err.max() <= STATE_ATOL, f"{label} {key}: {err.max()} > {STATE_ATOL}"
            continue
        assert err.max() <= 2 * LR * steps, f"{label} {key}: {err.max()} > 2 lr x {steps}"
        far = int((err > PARAM_LR_SHARE * LR * steps + 1e-7).sum())
        assert far <= 1 + 1e-3 * err.size, f"{label} {key}: {far} of {err.size} entries far"


@pytest.fixture(scope="module")
def f32_run():
    """JAX and the port, f32, VGG off, EMA 0.5: states before and after each
    of 3 steps, JAX's metrics, and JAX's step-0 gradients."""
    jcfg = tiny_gan_config()
    audio = _audio()
    g0, d0 = jax_states(jcfg, ema=EMA)
    step = jax_trainer.make_gan_train_step(jcfg, g_ema=EMA)
    g, d = g0, d0
    states, jax_metrics = [], []
    for key in _keys():
        g, d, m = step(g, d, jnp.asarray(audio), key)
        states.append((g, d))
        jax_metrics.append({k: float(v) for k, v in m.items()})
    grads = jax_step0_grads(jcfg, g0, d0, states[0][1], jnp.asarray(audio), _keys()[0])
    return {"jcfg": jcfg, "audio": audio, "flats": _flats(g0, d0), "jax_states": states,
            "jax_metrics": jax_metrics, "jax_grads": grads}


def _run_port(run, steps=STEPS, ema=EMA, **kw):
    g, d = _port_states(run["jcfg"], *run["flats"], ema=ema)
    step = make_gan_train_step(port_config(run["jcfg"]), g_ema=ema, **kw)
    audio = torch.tensor(run["audio"])
    out = []
    for key in _keys()[:steps]:
        g, d, m = step(g, d, audio, *gaps_of_key(key, 1, clips=audio.shape[0]))
        out.append(({k: float(v) for k, v in m.items()}, _grads(g, d) if not out else None))
    return g, d, out


def test_replica_of_the_jax_step_is_faithful(f32_run):
    *_, g_losses, d_losses = f32_run["jax_grads"]
    for k, v in {**g_losses, **d_losses}.items():
        np.testing.assert_allclose(float(v), f32_run["jax_metrics"][0][k], rtol=1e-6, err_msg=k)


def test_f32_step0_losses_and_gradients_match_jax(f32_run):
    _, _, out = _run_port(f32_run, steps=1)
    metrics, (g_grads, d_grads) = out[0]
    for k, v in f32_run["jax_metrics"][0].items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-5, err_msg=k)
    want_g, want_d, _, _ = f32_run["jax_grads"]
    _check_grads(g_grads, want_g, 1e-4, "G")
    # D's .grad after the whole step is the D step's: the G step added nothing.
    _check_grads(d_grads, want_d, 1e-4, "D")


@pytest.mark.parametrize("mode", ["plain", "remat", "fused", "remat_fused"])
def test_f32_steps_match_jax_in_every_mode(f32_run, mode):
    """3 steps from the same start: losses at each step, then every
    parameter, G's running statistics, D's u and sigma, and the EMA."""
    kw = {"remat": "remat" in mode, "fused_g_forward": "fused" in mode}
    g, d, out = _run_port(f32_run, **kw)
    for i, (metrics, _) in enumerate(out):
        for k, v in f32_run["jax_metrics"][i].items():
            np.testing.assert_allclose(metrics[k], v, rtol=1e-5 if i == 0 else 1e-4,
                                       err_msg=f"{mode} step {i} {k}")
    jg, jd = f32_run["jax_states"][-1]
    want_g, want_d = _flats(jg, jd)
    got_g, got_d = _port_flats(g, d)
    assert set(got_g) == set(want_g) and set(got_d) == set(want_d)
    _check_params(got_g, want_g, STEPS, f"{mode} G")
    _check_params(got_d, want_d, STEPS, f"{mode} D")
    ema = pconv_unet_flat_variables(g.ema_params)
    _check_params(ema, flatten({"params": jg.ema_params}), STEPS, f"{mode} EMA")
    assert all(m.norm.num_batches_tracked.item() == STEPS for m in (g.model.enc0, g.model.dec1))


def test_remat_and_fused_equal_the_plain_step_in_the_port(f32_run):
    runs = {mode: _run_port(f32_run, steps=2, **kw) for mode, kw in (
        ("plain", {}), ("remat", {"remat": True}), ("fused", {"fused_g_forward": True}))}
    g0, d0, out0 = runs["plain"]
    want = {**pconv_unet_flat_variables(g0.model.state_dict()),
            **discriminator_flat_variables(d0.model.state_dict())}
    for mode in ("remat", "fused"):
        g, d, out = runs[mode]
        for (m, _), (m0, _) in zip(out, out0):
            for k, v in m0.items():
                np.testing.assert_allclose(m[k], v, rtol=1e-6, err_msg=f"{mode} {k}")
        got = {**pconv_unet_flat_variables(g.model.state_dict()),
               **discriminator_flat_variables(d.model.state_dict())}
        for key, value in want.items():
            assert np.abs(got[key] - value).max() <= 1e-6, f"{mode} {key}"


def test_ema_is_an_exact_blend_and_serves(f32_run, tmp_path):
    """The EMA equals decay * ema + (1 - decay) * params replayed on the
    live trajectory (rtol 1e-6), lags the live weights, and exported with
    the running statistics it serves through the port's ``make_gan_runner``
    (``tests/test_gan.py:348-410``): the delivered PCM16 clip is the input's
    outside the gap, bit for bit, and the gap is filled."""
    g, d = _port_states(f32_run["jcfg"], *f32_run["flats"], ema=EMA)
    cfg = port_config(f32_run["jcfg"])
    step = make_gan_train_step(cfg, g_ema=EMA)
    audio = torch.tensor(f32_run["audio"])
    expect = {k: v.detach().clone() for k, v in g.model.named_parameters()}
    for key in _keys():
        g, d, _ = step(g, d, audio, *gaps_of_key(key, 1, clips=2))
        expect = {k: EMA * expect[k] + (1 - EMA) * p.detach() for k, p in g.model.named_parameters()}
    lag = 0.0
    for k, p in g.model.named_parameters():
        np.testing.assert_allclose(g.ema_params[k].numpy(), expect[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        lag = max(lag, float((g.ema_params[k] - p.detach()).abs().max()))
    assert lag > 0
    path = tmp_path / "ema.npz"
    export_params_npz(path, g.model, dtype=None, params=g.ema_params)
    flat = load_params_npz(path)
    want = pconv_unet_flat_variables({**g.model.state_dict(), **g.ema_params})
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    runner = make_gan_runner(cfg, path, device="cpu", mode="enhanced", transport_window=2048)
    clip = f32_run["audio"][:1]
    restored, generated = runner.inpaint_fn(torch.tensor(clip), torch.tensor([4000]),
                                            torch.tensor([800]))
    assert torch.isfinite(generated).all() and torch.isfinite(restored).all()
    patch, start = runner(clip, np.array([4000]), np.array([800]))
    client = to_pcm16(torch.tensor(clip)).numpy()
    delivered = composite_gap_patch(client, patch.numpy(), start.numpy())
    outside = np.ones(N, bool)
    outside[4000:4800] = False
    assert np.array_equal(delivered[0][outside], client[0][outside])
    assert not np.array_equal(delivered[0][~outside], client[0][~outside])


def test_export_takes_only_the_two_model_families(tmp_path):
    """``export_params_npz`` picks its flattener by the module's type: a
    discriminator is refused, as is a replacement parameter the generator
    does not have."""
    cfg = port_config(tiny_gan_config())
    g, d = create_gan_states(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    with pytest.raises(TypeError):
        export_params_npz(tmp_path / "d.npz", d.model)
    with pytest.raises(KeyError):
        export_params_npz(tmp_path / "g.npz", g.model, params={"no_such.weight": torch.zeros(1)})
    assert not list(tmp_path.iterdir())


def test_eval_step_matches_jax(f32_run):
    jcfg = f32_run["jcfg"]
    g0, d0 = jax_states(jcfg)
    key = jax.random.PRNGKey(9)
    want = jax_trainer.make_gan_eval_step(jcfg)(g0, d0, jnp.asarray(f32_run["audio"]), key)
    g, d = _port_states(jcfg, *f32_run["flats"])
    before = {k: v.clone() for k, v in {**g.model.state_dict(), **d.model.state_dict()}.items()}
    got = make_gan_eval_step(port_config(jcfg))(g, d, torch.tensor(f32_run["audio"]),
                                                *gaps_of_key(key, 1, clips=2))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, err_msg=k)
    for k, v in {**g.model.state_dict(), **d.model.state_dict()}.items():
        assert torch.equal(v, before[k]), k  # no update, nothing stored


def test_g_step_leaves_d_grads():
    """After a step D's ``.grad`` is the D loss's gradient alone (taken here
    again, by the port's own D, from the same start and batch): the G step
    neither accumulates into it nor replaces it."""
    jcfg = tiny_gan_config()
    cfg = port_config(jcfg)
    g, d = create_gan_states(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    start = {k: v.clone() for k, v in d.model.state_dict().items()}
    g_start = {k: v.clone() for k, v in g.model.state_dict().items()}
    audio = torch.tensor(_audio(1, seed=4))
    gaps = (torch.tensor([3000]),)
    make_gan_train_step(cfg)(g, d, audio, *gaps)
    got = {n: p.grad.clone() for n, p in d.model.named_parameters()}

    from ml_audio_inpainting_torch.train.gan_trainer import _batch
    from ml_audio_inpainting_torch.train.losses import discriminator_loss

    g2, d2 = create_gan_states(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    d2.model.load_state_dict(start)
    g2.model.load_state_dict(g_start)
    batch = _batch(cfg, audio, *gaps, None)
    with torch.no_grad():
        fake = g2.model(batch["impaired_magnitude"], batch["mask"])
    params = dict(d2.model.named_parameters())
    real, us, _ = d2.model.apply_sn(params, d2.model.sn_state(), batch["original_magnitude"])
    fk, _, _ = d2.model.apply_sn(params, us, fake)
    loss = discriminator_loss(real, fk)["d_total"]
    want = torch.autograd.grad(loss, list(params.values()))
    for (name, w) in zip(params, want):
        assert torch.allclose(got[name], w, rtol=1e-5, atol=1e-7 * float(w.abs().max())), name


def test_vgg_step_matches_jax():
    """One f32 step with the VGG terms on (B=1, configs/gan.yaml's lambdas
    4 and 500), JAX's seed-42 VGG carried across."""
    jcfg = tiny_gan_config()
    jcfg.training.lambda_vgg_perceptual = 4.0
    jcfg.training.lambda_vgg_style = 500.0
    audio = _audio(1, seed=2)
    key = jax.random.PRNGKey(21)
    vgg_model = jax_vgg.VGG19Features()  # vgg19_params' model and draws, initialised small
    vgg_vars = jax.jit(vgg_model.init)(jax.random.PRNGKey(42), jnp.zeros((1, 16, 16, 3)))
    g0, d0 = jax_states(jcfg)
    g1, d1, jm = jax_trainer.make_gan_train_step(jcfg, vgg=(vgg_model, vgg_vars))(
        g0, d0, jnp.asarray(audio), key)
    want_g, want_d, _, _ = jax_step0_grads(jcfg, g0, d0, d1, jnp.asarray(audio), key,
                                           vgg=(vgg_model, vgg_vars))
    vgg = VGG19Features()
    vgg.load_state_dict(vgg19_state_dict(flatten(vgg_vars)))
    g, d = _port_states(jcfg, *_flats(g0, d0))
    _, _, m = make_gan_train_step(port_config(jcfg), vgg=vgg)(
        g, d, torch.tensor(audio), *gaps_of_key(key, 1, clips=1))
    assert float(jm["g_vgg_perceptual"]) > 0 and float(jm["g_vgg_style"]) > 0
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-4, err_msg=k)
    g_grads, d_grads = _grads(g, d)
    _check_grads(g_grads, want_g, 1e-3, "G")
    _check_grads(d_grads, want_d, 1e-4, "D")


def test_bf16_step_matches_jax_bf16_and_keeps_f32_state():
    """One bf16 step against JAX's bf16 step from the same weights and
    batch (4 gaps a clip), then 2 more: state stays f32."""
    jcfg = tiny_gan_config()
    jcfg.data.train_n_gaps = 4
    cfg = port_config(jcfg)
    audio = _audio()
    keys = _keys()
    gaps = gaps_of_key(keys[0], 4, clips=2)
    g0, d0 = jax_states(jcfg, ema=EMA)
    jstep = jax_trainer.make_gan_train_step(jcfg, compute_dtype=jnp.bfloat16, g_ema=EMA)
    g1, d1, jm = jstep(g0, d0, jnp.asarray(audio), keys[0])
    want_g, want_d, _, _ = jax_step0_grads(jcfg, g0, d0, d1, jnp.asarray(audio), keys[0],
                                           dtype=jnp.bfloat16)
    g32, d32 = _port_states(jcfg, *_flats(g0, d0))
    make_gan_train_step(cfg)(g32, d32, torch.tensor(audio), *gaps)
    f32_grads = _grads(g32, d32)
    g, d = _port_states(jcfg, *_flats(g0, d0), ema=EMA)
    step = make_gan_train_step(cfg, compute_dtype=torch.bfloat16, g_ema=EMA)
    g, d, m = step(g, d, torch.tensor(audio), *gaps)
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=5e-3, atol=1e-6, err_msg=k)
    for got, want, f32, label in zip(_grads(g, d), (want_g, want_d), f32_grads, ("G", "D")):
        for key, value in want.items():
            conv_bias = key.endswith("/bias") and "/norm/" not in key
            ref = f32[key] if conv_bias else value.astype(np.float32)
            norm = np.linalg.norm(ref)
            err = np.linalg.norm(got[key] - ref)
            assert err <= BF16_GRAD_SHARE * norm, f"bf16 {label} {key}: {err} > share x {norm}"
    got_d = discriminator_flat_variables(d.model.state_dict())
    for key, value in _flats(g1, d1)[1].items():
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(got_d[key], value, rtol=0, atol=2e-2, err_msg=key)
    for key in keys[1:]:
        g, d, m = step(g, d, torch.tensor(audio), *gaps_of_key(key, 4, clips=2))
        assert all(np.isfinite(float(v)) for v in m.values())
    tensors = [*g.model.state_dict().values(), *d.model.state_dict().values(),
               *g.ema_params.values()]
    for opt in (g.optimizer, d.optimizer):
        for st in opt.state.values():
            tensors += [st["exp_avg"], st["exp_avg_sq"]]
    assert all(t.dtype in (torch.float32, torch.int64) for t in tensors)


def test_gan_yaml_loads_the_same_and_is_the_recipe():
    """``configs/gan.yaml`` loads to the same values in both packages (the
    discriminator's ``use_spectral_norm`` and ``channels`` dropped as JAX
    drops them), and ``gan_recipe_config`` is it at B=32 with 4 gaps a
    clip."""
    from ml_audio_inpainting_tpu.utils.config import load_config as jax_load
    from ml_audio_inpainting_torch.train.recipe import gan_recipe_config
    from ml_audio_inpainting_torch.utils.config import load_config

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "gan.yaml")
    mine, ref = load_config(path).to_dict(), jax_load(path).to_dict()
    for section in ("data", "model", "training"):
        for key, value in mine[section].items():
            assert value == ref[section][key], (section, key)
    yaml_dict = Config.from_dict({"model": {"discriminator": {"use_spectral_norm": False,
                                                              "channels": [1]}}})
    assert yaml_dict.model.discriminator.use_spectral_norm
    recipe = gan_recipe_config().to_dict()
    mine["data"]["train_n_gaps"] = 4
    mine["training"]["batch_size"] = 32
    for key in ("dataset", "root_path", "train_path", "valid_path", "test_path"):
        del mine["data"][key], recipe["data"][key]  # where the corpus lives, not the recipe
    for section in ("data", "model", "training"):
        assert recipe[section] == mine[section], section

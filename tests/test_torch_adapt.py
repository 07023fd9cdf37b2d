"""Per-clip test-time adaptation in the port (``runtime/adapt.py``) against
the JAX package's (``runtime/adapt.py``) on the CPU, with
``tests/test_adapt.py``'s tiny GAN and 2.5 s clip (1 s for the step).

* ``make_gan_adapt_step``: one step from the same weights on the features
  of JAX's own gaps (``test_torch_gan_features.gaps_of_key`` hands the
  port the positions JAX's key gives): the losses within rtol 1e-5; every
  parameter after Adam (lr 1e-4) within 2 lr of JAX's and all but 1 + 0.1 %
  of a tensor within 0.05 lr (the sign-flip bound of
  ``tests/test_torch_gan_train.py``); the BatchNorm statistics within 1e-5
  (values of order 1).
* ``probe_positions_for``: equal to JAX's, element for element, over a grid
  of clips and gaps, and the same refusal.
* The adapter (port only; JAX's CLI draws other gaps, so its adapted
  weights differ): the runner's generator bit for bit as it was after each
  clip; step 0 kept, the generator itself returned, when adaptation hurts
  (steps that leave NaN weights) and whenever step 0 scores best (lr 1e3,
  as ``tests/test_adapt.py``'s test); the served output finite.  ``tests/test_torch_cli.py`` holds ``evaluate --adapt-steps``
  against JAX's CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_adapt import _clip, tiny_gan_config
from test_torch_gan_features import gaps_of_key
from test_torch_refiner import flatten, nest
from torch_threads import one_thread  # noqa: F401  (a module fixture)

from ml_audio_inpainting_tpu.runtime import adapt as jax_adapt
from ml_audio_inpainting_tpu.train.gan_trainer import build_generator as jax_build_generator
from ml_audio_inpainting_torch.models.build import build_generator
from ml_audio_inpainting_torch.runtime import adapt
from ml_audio_inpainting_torch.runtime.inference import make_gan_inpaint_fn
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.weights import pconv_unet_flat_variables, pconv_unet_state_dict

N = 40000
LR = 1e-4
STATE_ATOL = 1e-5
PARAM_LR_SHARE = 0.05


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_gan_config()
    net = jax_build_generator(jcfg)
    frames = 1 + N // 128
    variables = jax.jit(lambda k, a, m: net.init(k, a, m, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 257, frames)), jnp.ones((1, 257, frames)))
    rng = np.random.default_rng(3)
    flat = {k: (rng.uniform(0.5, 2.0, v.shape) if k.endswith("/var")
                else v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flatten(variables).items()}
    cfg = Config.from_dict(jcfg.to_dict())
    gen = build_generator(cfg, "cpu")
    gen.load_state_dict(pconv_unet_state_dict(flat))
    return {"jcfg": jcfg, "net": net, "flat": flat, "cfg": cfg, "gen": gen.eval()}


def test_adapt_step_matches_jax_on_jaxs_features(tiny):
    n = 16000  # 1 s: the generator takes any length
    audio = np.stack([_clip(n), 0.7 * _clip(n)[::-1].copy()])
    key = jax.random.PRNGKey(5)
    jvars = nest(tiny["flat"])
    init_fn, step_fn = jax_adapt.make_gan_adapt_step(tiny["jcfg"], tiny["net"], lr=LR, n_gaps=2)
    (params, stats, _), jlosses = step_fn(jvars["params"], jvars["batch_stats"],
                                          init_fn(jvars["params"]), jnp.asarray(audio), key)
    p_init, p_step = adapt.make_gan_adapt_step(tiny["cfg"], lr=LR, n_gaps=2)
    gen = build_generator(tiny["cfg"], "cpu")
    gen.load_state_dict(tiny["gen"].state_dict())
    losses = p_step(gen, p_init(gen), torch.from_numpy(audio),
                    *gaps_of_key(key, 2, clips=2, n=n, gap_s=tiny["jcfg"].data.gap_len_s))
    for k in ("g_total", "g_l1_valid", "g_l1_hole", "g_mag_weighted"):
        assert losses[k].item() == pytest.approx(float(jlosses[k]), rel=1e-5), k
    assert losses["g_vgg_style"].item() == 0.0 and float(jlosses["g_total"]) > 0
    got = pconv_unet_flat_variables(gen.state_dict())
    want = flatten({"params": params, "batch_stats": stats})
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.abs(got[k] - w)
        if k.startswith("batch_stats/"):
            assert err.max() <= STATE_ATOL, f"{k}: {err.max()}"
            continue
        assert err.max() <= 2 * LR, f"{k}: {err.max()} > 2 lr"
        far = int((err > PARAM_LR_SHARE * LR + 1e-7).sum())
        assert far <= 1 + 1e-3 * err.size, f"{k}: {far} of {err.size} entries far"
    moved = [k for k in want if np.abs(got[k] - tiny["flat"][k]).max() > 0]
    assert any(k.startswith("batch_stats/") for k in moved) and len(moved) > len(want) // 2


@pytest.mark.parametrize("n_samples,gap_start,gap_len,n_probes", [
    (80000, 32000, 1280, 4), (80000, 1000, 2048, 4), (80000, 77000, 1280, 6),
    (40000, 19200, 1280, 2), (40000, 12000, 3200, 8), (40000, 30000, 640, 3)])
def test_probe_positions_match_jax(n_samples, gap_start, gap_len, n_probes):
    got = adapt.probe_positions_for(n_samples, gap_start, gap_len, 16000, n_probes=n_probes)
    want = jax_adapt.probe_positions_for(n_samples, gap_start, gap_len, 16000, n_probes=n_probes)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_probe_positions_refuse_like_jax():
    for fn in (adapt.probe_positions_for, jax_adapt.probe_positions_for):
        with pytest.raises(ValueError, match="no probe positions"):
            fn(40000, 0, 40000, 16000)


def _snapshot(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def _same(module, snap):
    return all(torch.equal(v, snap[k]) for k, v in module.state_dict().items())


@pytest.mark.parametrize("lr,hurt", [(1e-4, False), (1e3, False), (1e-4, True)],
                         ids=["adapts", "diverges", "hurts"])
def test_adapter_leaves_the_runner_untouched(tiny, lr, hurt):
    """Two clips through one adapter: the runner's generator bit for bit
    after each.  When adaptation hurts (here: each step leaves NaN weights,
    which no probe score beats) the gate ships step 0, the generator
    itself; with lr 1e3 it does so whenever step 0 scores best, as in
    ``tests/test_adapt.py``."""
    gen = tiny["gen"]
    snap = _snapshot(gen)

    def factory(g):
        return make_gan_inpaint_fn(tiny["cfg"], g, mode="enhanced")

    adapter = adapt.GanClipAdapter(tiny["cfg"], factory, steps=2, lr=lr, batch=2, probe_every=2,
                                   n_probes=2, n_gaps=2, ar_order=32, ar_context=256)
    if hurt:
        step_fn = adapter.step_fn

        def hurting(g, *args):
            out = step_fn(g, *args)
            with torch.no_grad():
                for p in g.parameters():
                    p.fill_(float("nan"))
            return out

        adapter.step_fn = hurting
    for seed, clip in enumerate((_clip(), 0.5 * _clip())):
        best, info = adapter.adapt(gen, torch.from_numpy(clip), 19200, 1280, seed=seed)
        assert _same(gen, snap) and not gen.training
        assert [s for s, _ in info["probe_trajectory"]] == [0, 2]
        assert info["probe_starts"] == [int(s) for s in adapt.probe_positions_for(
            N, 19200, 1280, 16000, n_probes=2)]
        assert info["best_probe_sdr"] >= info["probe_trajectory"][0][1]
        if hurt:
            assert info["best_step"] == 0 and np.isnan(info["probe_trajectory"][1][1])
        if info["best_step"] == 0:
            assert best is gen
        else:
            assert best is not gen and not _same(best, snap)
        r = factory(best)(torch.from_numpy(clip)[None], torch.tensor([19200]),
                          torch.tensor([1280]))[0]
        assert r.shape == (1, N) and torch.isfinite(r).all()
    assert _same(gen, snap)


def test_adapt_gan_variables_and_device_draws(tiny):
    """The one-clip wrapper, and the step's gaps drawn on the device from a
    ``torch.Generator``: starts and lengths inside the clip, 1 or K gaps."""
    best, info = adapt.adapt_gan_variables(
        tiny["cfg"], tiny["gen"], lambda g: make_gan_inpaint_fn(tiny["cfg"], g, mode="enhanced"),
        torch.from_numpy(_clip()), 19200, 1280, steps=1, batch=2, probe_every=1, n_probes=2,
        n_gaps=1, ar_order=32, ar_context=256)
    assert info["best_step"] in (0, 1) and len(info["probe_trajectory"]) == 2
    gen = torch.Generator().manual_seed(0)
    (starts,) = adapt.draw_adapt_gaps(gen, tiny["cfg"], 3, N, 1)
    assert starts.shape == (3,) and ((starts >= 0) & (starts <= N - 1280)).all()
    starts, lengths = adapt.draw_adapt_gaps(gen, tiny["cfg"], 3, N, 4)
    assert starts.shape == lengths.shape == (3, 4) and starts.dtype == torch.int64
    assert ((starts >= 0) & (starts + lengths <= N) & (lengths <= 1280)).all()

"""The gap refiner in the port (``models/refiner.py``,
``train/refiner_trainer.py``'s windows, loss, probe and serving,
``weights.py``'s refiner pair) against the JAX package's on the CPU
(training: ``tests/test_torch_refiner_train.py``).

The GAN is ``tests/test_adapt.py``'s tiny config at 1.5 s clips (the
training gaps keep 8192 samples of margin a side), its weights JAX's init
carried across; one test runs the committed full-width GAN on one 2.5 s clip.
The head is the committed ``refiner_formant_v2_r3.npz`` (C=64) unless said
otherwise.  Inputs are seeded with numpy.

Tolerances (f32; every sum in another order):

* the head alone, on the same inputs: within 1e-5 of the output's peak
  (measured 2.5e-7).  The witness: the head with the exact (erf) GELU lies
  1.4e-4 of the peak from JAX's tanh form, outside that bound;
* the example windows: ``clean``, ``impaired``, ``gap_ind`` and ``start``
  exactly; the GAN channel within 2e-5 (``tests/test_torch_gan_inference.py``'s
  waveform bound; measured 3.8e-6); the AR channel within 5e-4 of its peak
  (``tests/test_torch_arinpaint.py``'s f32 bound; measured 3.3e-5: the
  order-512 Levinson rounds apart);
* served clips: outside the gap the input bit for bit in both packages;
  inside it the AR bound (the head adds its delta to the AR fill);
* the gap loss on the same windows within rtol 1e-6; the probe's two dB
  means after the solvers within 1e-3 absolute.
"""

from collections.abc import Mapping
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_adapt import tiny_gan_config

from ml_audio_inpainting_tpu.models.refiner import WaveRefiner as JaxRefiner
from ml_audio_inpainting_tpu.models.refiner import window_bounds as jax_window_bounds
from ml_audio_inpainting_tpu.train import refiner_trainer as jrt
from ml_audio_inpainting_tpu.train.checkpoints import load_params_npz as jax_load_npz
from ml_audio_inpainting_tpu.train.gan_trainer import build_generator as jax_build_generator
from ml_audio_inpainting_torch.models import refiner as port_refiner
from ml_audio_inpainting_torch.models.build import build_generator
from ml_audio_inpainting_torch.models.refiner import WaveRefiner, window_bounds
from ml_audio_inpainting_torch.runtime.serve import load_generator
from ml_audio_inpainting_torch.train import refiner_trainer as rt
from ml_audio_inpainting_torch.train.checkpoints import export_params_npz
from ml_audio_inpainting_torch.utils.config import Config, gan_profile_config
from ml_audio_inpainting_torch.weights import (
    load_params_npz,
    pconv_unet_state_dict,
    refiner_channels,
    refiner_flat_variables,
    refiner_state_dict,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture)

REPO = Path(__file__).resolve().parent.parent
HEAD = REPO / "results" / "checkpoints" / "refiner_formant_v2_r3.npz"
GAN = REPO / "results" / "checkpoints" / "gan_formant_v2_r2.npz"
SR = 16000
S = 24000  # 1.5 s: the training gaps keep MARGIN samples clear a side
HEAD_RTOL = 1e-5
NEURAL_ATOL = 2e-5
AR_RTOL = 5e-4
LOSS_ATOL = 1e-3
LR = 3e-4
PARAM_LR_SHARE = 0.05


def jax_state(params, lr=LR):
    """JAX's ``RefinerState`` of ``params`` (``create_refiner_state``
    without its eager init)."""
    return jrt.RefinerState.create(apply_fn=JaxRefiner(channels=64).apply, params=params,
                                   tx=optax.adam(lr))


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flatten(v, key) if isinstance(v, Mapping) else {key: np.asarray(v)})
    return out


def nest(flat):
    out: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(value)
    return out


def speech(seed, clips, n=S, loud_half=False):
    """Seeded harmonic clips; ``loud_half`` makes the second half 10x louder
    (the candidate pick then has no near-tie)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    out = []
    for _ in range(clips):
        x = (0.5 * np.sin(2 * np.pi * rng.uniform(100, 300) * t)
             + 0.25 * np.sin(2 * np.pi * rng.uniform(600, 1200) * t + rng.uniform(0, 6))
             ) * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1, 3) * t))
        x = x + 0.02 * rng.standard_normal(n)
        if loud_half:
            x = x * np.where(t < n / SR / 2, 0.1, 1.0)
        out.append(x)
    return np.stack(out).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    """The tiny GAN at 1.5 s in both packages, from JAX's init redrawn
    with seeded values (JAX's init keeps most BatchNorm statistics at
    their start)."""
    jcfg = tiny_gan_config()
    jcfg.data.max_len_s = S / SR
    net = jax_build_generator(jcfg)
    frames = 1 + S // 128
    variables = jax.jit(lambda k, a, m: net.init(k, a, m, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 257, frames)), jnp.ones((1, 257, frames)))
    rng = np.random.default_rng(1)
    flat = {k: (rng.uniform(0.5, 2.0, v.shape) if k.endswith("/var")
                else v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in flatten(variables).items()}
    cfg = Config.from_dict(jcfg.to_dict())
    gen = build_generator(cfg, "cpu")
    gen.load_state_dict(pconv_unet_state_dict(flat))
    return {"jcfg": jcfg, "net": net, "vars": nest(flat), "cfg": cfg, "gen": gen.eval()}


def _head_inputs(seed, b=2, w=4096):
    rng = np.random.default_rng(seed)
    chans = [(0.3 * rng.standard_normal((b, w))).astype(np.float32) for _ in range(3)]
    ind = np.zeros((b, w), np.float32)
    ind[0, 1024:2304] = 1.0
    ind[1, 1500:1900] = 1.0
    chans[0] *= 1.0 - ind  # the impaired channel is zero in the gap
    return chans + [ind]


# ------------------------------------------------------------------- the head


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_head_matches_jax_from_the_committed_npz(monkeypatch, gelu):
    """Full width (C=64, 18 blocks) on seeded 4096-sample windows: JAX's head
    within 1e-5 of its peak.  With the exact GELU the port lies outside
    that bound: the witness that flax's ``nn.gelu`` is the tanh form."""
    inputs = _head_inputs(0)
    want = np.asarray(JaxRefiner(channels=64).apply(jax_load_npz(HEAD),
                                                    *map(jnp.asarray, inputs)))
    if gelu == "erf":
        monkeypatch.setattr(port_refiner, "_gelu", torch.nn.functional.gelu)
    head = rt.load_refiner(load_params_npz(HEAD), "cpu")
    with torch.no_grad():
        got = head(*map(torch.from_numpy, inputs)).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    if gelu == "tanh":
        assert err <= HEAD_RTOL, err
    else:
        assert err > 10 * HEAD_RTOL, err
    ind = inputs[3] > 0
    np.testing.assert_array_equal(got[~ind], inputs[0][~ind])


def test_fresh_head_is_the_ar_fill_bit_for_bit():
    """A fresh head (zero last projection) returns the AR channel inside the
    gap and the impaired one outside, exactly, as JAX's does; after a
    perturbation the gap moves and the rest does not."""
    impaired, ar, neural, ind = map(torch.from_numpy, _head_inputs(1))
    head = WaveRefiner(channels=8, dilations=(1, 2, 4)).init_weights(torch.Generator().manual_seed(3))
    assert not head.Conv_2.weight.any() and not head.Conv_2.bias.any()
    with torch.no_grad():
        out = head(impaired, ar, neural, ind)
        assert torch.equal(out, torch.where(ind > 0, ar, impaired))
        for p in head.parameters():
            p.add_(0.05)
        moved = head(impaired, ar, neural, ind)
    assert torch.equal(moved[ind == 0], impaired[ind == 0])
    assert not torch.allclose(moved[ind > 0], ar[ind > 0])
    jm = JaxRefiner(channels=8, dilations=(1, 2, 4))
    z = jax.ShapeDtypeStruct((1, 512), jnp.float32)
    jvars = jax.eval_shape(jm.init, jax.random.PRNGKey(0), z, z, z, z)
    assert {k.replace("_DilatedBlock_", "blocks.").replace("/", ".") for k in flatten(jvars)} == {
        "params." + k.replace(".weight", ".kernel") for k in head.state_dict()}


def test_init_draws_lecun_normal_with_zero_biases():
    head = WaveRefiner().init_weights(torch.Generator().manual_seed(0))
    w = head.blocks[0].Conv_0.weight  # fan-in 3 x 64
    assert abs(w.std().item() - (1 / (3 * 64)) ** 0.5) < 5e-3
    assert w.abs().max().item() <= 2 * (1 / (3 * 64)) ** 0.5 / 0.8796 + 1e-6
    assert all(not m.bias.any() for m in head.modules() if isinstance(m, torch.nn.Conv1d))
    assert sum(p.numel() for p in head.parameters()) == 302273


@pytest.mark.parametrize("gap_start,gap_len,n", [
    (100, 500, 24000), (12000, 1280, 24000), (23500, 400, 24000), (3000, 2048, 4096)],
    ids=["left-clamp", "inside", "right-clamp", "clip-as-long-as-window"])
def test_window_bounds_matches_jax(gap_start, gap_len, n):
    got = window_bounds(torch.tensor([gap_start]), torch.tensor([gap_len]), rt.WINDOW, rt.MAX_GAP, n)
    want = jax_window_bounds(jnp.asarray([gap_start]), jnp.asarray([gap_len]), jrt.WINDOW,
                             jrt.MAX_GAP, n)
    assert [int(v) for v in got] == [int(np.asarray(v)[0]) for v in want]
    assert (rt.WINDOW, rt.MAX_GAP) == (jrt.WINDOW, jrt.MAX_GAP)


def test_weights_round_trip_through_jax(tmp_path):
    """The committed npz loads strictly (78 arrays, C=64); the port's export
    of a seeded head loads in JAX's ``load_params_npz`` and gives JAX's
    output there; ``refiner_channels`` reads JAX's width."""
    flat = load_params_npz(HEAD)
    assert len(flat) == 78 and refiner_channels(flat) == 64
    assert refiner_channels(flat) == jrt.refiner_channels(jax_load_npz(HEAD))
    WaveRefiner(64).load_state_dict(refiner_state_dict(flat))  # strict
    back = refiner_flat_variables(WaveRefiner(64).state_dict())
    assert set(back) == set(flat)
    head = WaveRefiner(channels=16).init_weights(torch.Generator().manual_seed(2))
    with torch.no_grad():
        head.Conv_2.weight.normal_(0, 0.1, generator=torch.Generator().manual_seed(4))
    export_params_npz(tmp_path / "head.npz", head, dtype=None)
    jvars = jax_load_npz(tmp_path / "head.npz")
    assert jrt.refiner_channels(jvars) == 16
    inputs = _head_inputs(2)
    want = np.asarray(JaxRefiner(channels=16).apply(jvars, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = head(*map(torch.from_numpy, inputs)).numpy()
    assert np.abs(got - want).max() <= HEAD_RTOL * np.abs(want).max()
    with pytest.raises(ValueError, match="unexpected refiner weight key"):
        refiner_state_dict({"params/Dense_0/kernel": np.zeros((2, 2))})


@pytest.mark.parametrize("b,gate", [(4, True), (5, True), (4, False)],
                         ids=["even-gated", "odd-gated", "ungated"])
def test_gap_loss_matches_jax(b, gate):
    """At an even batch ``jnp.median`` averages the two middle values, the
    port too (``torch.median`` would take the lower one: the witness)."""
    rng = np.random.default_rng(b)
    out, clean = (rng.standard_normal((2, b, 4096)) * [[[0.3]], [[1.0]]]).astype(np.float32)
    clean *= np.linspace(0.1, 2.0, b, dtype=np.float32)[:, None]
    ind = np.zeros((b, 4096), np.float32)
    ind[:, 1000:2000] = 1.0
    want = float(jrt._gap_loss(*map(jnp.asarray, (out, clean, ind)), energy_gate=gate))
    got = rt._gap_loss(*map(torch.from_numpy, (out, clean, ind)), energy_gate=gate).item()
    assert got == pytest.approx(want, rel=1e-6)
    ref = torch.from_numpy((clean**2 * ind).sum(-1))
    assert rt._median(ref).item() == pytest.approx(float(jnp.median(jnp.asarray(ref.numpy()))),
                                                   rel=1e-7)
    if gate and b % 2 == 0:
        assert rt._median(ref) != torch.median(ref)


# ------------------------------------------------- the solvers, serving, probe


def _check_examples(got, want):
    for key in ("clean", "impaired", "gap_ind", "start"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert np.abs(got["neural"].numpy() - np.asarray(want["neural"])).max() <= NEURAL_ATOL
    ar_w = np.asarray(want["ar"])
    assert np.abs(got["ar"].numpy() - ar_w).max() <= AR_RTOL * np.abs(ar_w).max()


def test_example_fn_matches_jax(tiny):
    """Gaps inside the clip, at the longest length, and one whose window
    clamps at the clip's end."""
    audio = speech(3, 4)
    gs, gl = np.array([9000, 12000, 15000, 22500]), np.array([1280, 700, 2048, 900])
    want = jrt.make_example_fn(tiny["jcfg"], tiny["net"], tiny["vars"])(
        jnp.asarray(audio), jnp.asarray(gs), jnp.asarray(gl))
    got = rt.make_example_fn(tiny["cfg"], tiny["gen"])(
        torch.from_numpy(audio), torch.from_numpy(gs), torch.from_numpy(gl))
    _check_examples(got, want)


def test_example_fn_clips_a_blown_ar_fill(tiny):
    """A gap whose context is near-silent: the channels stay finite and
    within +-4 (``nan_to_num``, then the clip)."""
    audio = speech(4, 2)
    audio[:, :14000] *= 1e-7
    ex = rt.make_example_fn(tiny["cfg"], tiny["gen"])(
        torch.from_numpy(audio), torch.tensor([12000, 12000]), torch.tensor([1280, 2048]))
    for key in ("ar", "neural"):
        assert torch.isfinite(ex[key]).all() and ex[key].abs().max() <= rt.CHANNEL_CLIP


def test_apply_fn_and_probe_match_jax(tiny):
    """Served clips (the committed head over the tiny GAN) and the probe's
    two dB means, at 2.0 s's stand-in positions."""
    audio = speech(5, 3)
    gs, gl = np.array([8000, 12000, 20000]), np.array([1280, 1280, 1280])
    jvars = jax_load_npz(HEAD)
    want = np.asarray(jrt.make_refiner_apply_fn(tiny["jcfg"], tiny["net"], tiny["vars"])(
        jvars, jnp.asarray(audio), jnp.asarray(gs), jnp.asarray(gl)))
    head = rt.load_refiner(load_params_npz(HEAD), "cpu")
    got = rt.make_refiner_apply_fn(tiny["cfg"], tiny["gen"])(
        head, torch.from_numpy(audio), torch.from_numpy(gs), torch.from_numpy(gl)).numpy()
    gap = np.zeros_like(audio, bool)
    for i, (s, n) in enumerate(zip(gs, gl)):
        gap[i, s:s + n] = True
    np.testing.assert_array_equal(got[~gap], audio[~gap])
    np.testing.assert_array_equal(want[~gap], audio[~gap])
    assert np.abs(got - want)[gap].max() <= AR_RTOL * np.abs(want[gap]).max()

    jstate = jax_state(jvars["params"])
    want_p = [float(v) for v in jrt.make_refiner_probe_fn(tiny["jcfg"], tiny["net"], tiny["vars"])(
        jstate, jnp.asarray(audio), jnp.asarray(gs, jnp.int32))]
    got_p = [v.item() for v in rt.make_refiner_probe_fn(tiny["cfg"], tiny["gen"])(
        head, torch.from_numpy(audio), torch.from_numpy(gs))]
    assert np.allclose(got_p, want_p, atol=LOSS_ATOL), (got_p, want_p)


def test_apply_fn_full_width_gan_matches_jax():
    """The committed GAN at its default widths and the committed head on one
    seeded 2.5 s clip (the networks take any length), an 80 ms gap at 2.0 s."""
    jcfg = __import__("ml_audio_inpainting_tpu.utils.config", fromlist=["x"]).gan_profile_config(None)
    cfg = gan_profile_config(None)
    audio = speech(6, 1, n=40000)
    gs, gl = np.array([32000]), np.array([1280])
    want = np.asarray(jrt.make_refiner_apply_fn(jcfg, jax_build_generator(jcfg), jax_load_npz(GAN))(
        jax_load_npz(HEAD), jnp.asarray(audio), jnp.asarray(gs), jnp.asarray(gl)))
    got = rt.make_refiner_apply_fn(cfg, load_generator(cfg, GAN, "cpu"))(
        rt.load_refiner(load_params_npz(HEAD), "cpu"), torch.from_numpy(audio),
        torch.from_numpy(gs), torch.from_numpy(gl)).numpy()
    gap = slice(32000, 33280)
    np.testing.assert_array_equal(got[0, :32000], audio[0, :32000])
    assert np.abs(got - want)[0, gap].max() <= AR_RTOL * np.abs(want[0, gap]).max()

"""Multi-gap corruption in the port (``ml_audio_inpainting_torch/data/multigap.py``,
the ``n_gaps > 1`` path of ``train/features.py::cnn_features``, the
production recipe of ``train/recipe.py``) and ``utils/precision.py::cast_floating``
against the JAX package on the CPU.

* The layout is integer arithmetic over f32 draws, so it is held exact:
  fed the uniforms that ``multi_gap_mask`` draws from a key's two halves,
  the port gives JAX's ``starts``, ``lengths`` and mask bit for bit, over
  keys, gap counts, clip lengths (including clips too short for the gaps,
  where the lengths shrink) and gap lengths.
* The port's own sampler keeps the construction's guarantees: gaps
  ordered, at least ``min_dist_samples`` apart and from both edges, lengths
  within [min, max) when they fit.
* ``cnn_features`` with three gaps a variant against JAX's from the same
  key, the port given the positions JAX draws: masks exact, ``log_gap`` to
  ``atol=1e-4`` plus ``rtol=2e-4`` and ``target_mag`` to ``atol=1e-4`` (the
  bounds of ``tests/test_torch_cnn_train.py``: FFT rounding).  Clips are
  1.2 s: three gaps and their 4096-sample spacing need more than 1.03 s.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ml_audio_inpainting_tpu.data.multigap import multi_gap_mask as jax_multi_gap_mask
from ml_audio_inpainting_tpu.train import features as jax_features
from ml_audio_inpainting_tpu.utils.config import Config as JaxConfig
from ml_audio_inpainting_torch.data.multigap import (
    gaps_mask,
    multi_gap_layout,
    multi_gap_mask,
    random_multi_gap_layout,
)
from ml_audio_inpainting_torch.train.features import cnn_features
from ml_audio_inpainting_torch.train.recipe import b128_recipe_config, multi_gap_layouts
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.utils.precision import cast_floating
from torch_threads import one_thread  # noqa: F401  (a module fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
MIN_DIST = 4096


def _jax_uniforms(key, n_gaps):
    """The uniforms ``multi_gap_mask`` draws: [0, 1) floats from the two
    halves of ``key`` (lengths, then positions)."""
    k_len, k_pos = jax.random.split(key)
    return [torch.tensor(np.asarray(jax.random.uniform(k, (n_gaps,)))) for k in (k_len, k_pos)]


def _assert_same_as_jax(seed, n_gaps, audio_len, max_gap_ms):
    key = jax.random.PRNGKey(seed)
    want = jax_multi_gap_mask(key, audio_len, n_gaps, max_gap_ms=max_gap_ms, sample_rate=SR)
    got = multi_gap_mask(*_jax_uniforms(key, n_gaps), audio_len, max_gap_ms=max_gap_ms,
                         sample_rate=SR)
    for name, g, w in zip(("mask", "starts", "lengths"), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{name} (seed {seed})")


@pytest.mark.parametrize("n_gaps", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("audio_len,max_gap_ms", [(80000, 200.0), (19200, 50.0), (30000, 500.0),
                                                  (8000, 80.0)])
def test_layout_matches_jax_bit_for_bit(n_gaps, audio_len, max_gap_ms):
    """Ten keys each; the 8000-sample clip holds no two gaps with their
    spacing, so there the lengths shrink and the slots are empty."""
    for seed in range(10):
        _assert_same_as_jax(seed, n_gaps, audio_len, max_gap_ms)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n_gaps=st.integers(1, 6),
       audio_len=st.sampled_from([12000, 24000, 80000]),
       max_gap_ms=st.sampled_from([40.0, 200.0, 700.0]))
def test_layout_matches_jax_on_drawn_keys(seed, n_gaps, audio_len, max_gap_ms):
    _assert_same_as_jax(seed, n_gaps, audio_len, max_gap_ms)


def _check_guarantees(starts, lengths, audio_len, min_len, max_len):
    starts, lengths = starts.long(), lengths.long()
    ends = starts + lengths
    assert (starts[..., 0] >= MIN_DIST).all()  # clear of the start
    assert (starts[..., 1:] - ends[..., :-1] >= MIN_DIST).all()  # ordered and spaced
    assert (audio_len - ends[..., -1] >= MIN_DIST).all()  # clear of the end
    assert ((lengths >= min_len) & (lengths < max_len)).all()


@pytest.mark.parametrize("audio_len,n_gaps,max_gap_ms", [(80000, 3, 200.0), (80000, 10, 80.0),
                                                         (19200, 3, 50.0), (40000, 1, 1000.0)])
def test_sampler_keeps_the_construction_guarantees(audio_len, n_gaps, max_gap_ms):
    gen = torch.Generator().manual_seed(audio_len + n_gaps)
    starts, lengths = random_multi_gap_layout(gen, (64, 3), audio_len, n_gaps,
                                              max_gap_ms=max_gap_ms, sample_rate=SR)
    assert starts.shape == lengths.shape == (64, 3, n_gaps)
    assert starts.dtype == lengths.dtype == torch.int32
    _check_guarantees(starts, lengths, audio_len, 160, max_gap_ms * SR / 1000)
    assert len(set(starts[..., 0].flatten().tolist())) > 32  # the positions are drawn
    mask = gaps_mask(audio_len, starts[0, 0], lengths[0, 0])
    assert mask.sum() == audio_len - lengths[0, 0].sum()
    for s, n in zip(starts[0, 0].tolist(), lengths[0, 0].tolist()):
        assert not mask[s:s + n].any() and mask[s - 1] == 1 and mask[s + n] == 1


def test_sampler_is_seeded_and_batched_like_single_draws():
    a = random_multi_gap_layout(torch.Generator().manual_seed(3), (4, 2), 80000, 3)
    b = random_multi_gap_layout(torch.Generator().manual_seed(3), (4, 2), 80000, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # A batch of draws lays each row out as the single function does.
    gen = torch.Generator().manual_seed(8)
    u_len, u_pos = torch.rand(5, 3, generator=gen), torch.rand(5, 3, generator=gen)
    starts, lengths = multi_gap_layout(u_len, u_pos, 80000)
    for i in range(5):
        one = multi_gap_layout(u_len[i], u_pos[i], 80000)
        assert torch.equal(one[0], starts[i]) and torch.equal(one[1], lengths[i])


def test_gaps_mask_matches_jax_masks_row_by_row():
    keys = [jax.random.PRNGKey(s) for s in (21, 22, 23)]
    want = [jax_multi_gap_mask(k, 24000, 3, max_gap_ms=300.0) for k in keys]
    starts = torch.tensor(np.stack([np.asarray(w[1]) for w in want]))
    lengths = torch.tensor(np.stack([np.asarray(w[2]) for w in want]))
    got = gaps_mask(24000, starts, lengths)
    np.testing.assert_array_equal(got.numpy(), np.stack([np.asarray(w[0]) for w in want]))


# ---------------------------------------------------------------- features

CLIPS, VARIANTS, N_GAPS, CLIP_S, GAP_S = 2, 2, 3, 1.2, 0.05
N_SAMPLES = int(SR * CLIP_S)


def _audio(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(N_SAMPLES) / SR
    clips = [np.sin(2 * np.pi * rng.uniform(100, 300) * t) * (0.5 + 0.5 * np.sin(2 * np.pi * t))
             + 0.05 * rng.standard_normal(N_SAMPLES) for _ in range(CLIPS)]
    return np.stack(clips).astype(np.float32)


def jax_gap_layout(key, clips=CLIPS, variants=VARIANTS, n_gaps=N_GAPS, n=N_SAMPLES, gap_s=GAP_S):
    """The ``(starts, lengths)`` that JAX's ``cnn_features`` lays out from
    ``key``: one ``multi_gap_mask`` per split, clips by variants."""
    keys = jax.random.split(key, clips * variants).reshape(clips, variants, -1)
    _, starts, lengths = jax.vmap(jax.vmap(lambda k: jax_multi_gap_mask(
        k, n, n_gaps, max_gap_ms=gap_s * 1000.0, sample_rate=SR)))(keys)
    return (torch.tensor(np.asarray(starts), dtype=torch.int64),
            torch.tensor(np.asarray(lengths), dtype=torch.int64))


@pytest.mark.parametrize("seed", [7, 8])
def test_cnn_features_with_three_gaps_match_jax(seed):
    spec = JaxConfig().data.spectrogram
    audio = _audio(seed)
    key = jax.random.PRNGKey(seed)
    want = jax_features.cnn_features(jnp.asarray(audio), key, spec, gap_len_s=GAP_S,
                                     sample_rate=SR, n_samples=N_SAMPLES,
                                     gaps_per_audio=VARIANTS, n_gaps=N_GAPS)
    starts, lengths = jax_gap_layout(key)
    got = cnn_features(torch.tensor(audio), starts, Config().data.spectrogram, gap_len_s=GAP_S,
                       sample_rate=SR, n_gaps=N_GAPS, gap_len=lengths)
    assert set(got) == {"log_gap", "gap_mask", "target_mag"}
    for k in got:
        assert got[k].shape == want[k].shape == (CLIPS * VARIANTS, 257, 101)
    holes = got["gap_mask"][:, 0].sum(-1)
    assert (holes > 0).all() and (holes < 101).all()
    np.testing.assert_array_equal(got["gap_mask"].numpy(), np.asarray(want["gap_mask"]))
    np.testing.assert_allclose(got["log_gap"].numpy(), np.asarray(want["log_gap"]),
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(got["target_mag"].numpy(), np.asarray(want["target_mag"]),
                               rtol=0, atol=1e-4)


def test_cnn_features_with_several_gaps_need_their_lengths():
    spec = Config().data.spectrogram
    audio = torch.zeros(2, N_SAMPLES)
    starts = torch.full((2, 1, 3), 5000)
    with pytest.raises(ValueError, match="gap_len"):
        cnn_features(audio, starts, spec, n_gaps=3)
    with pytest.raises(ValueError, match=r"\(B, G, 3\)"):
        cnn_features(audio, starts[..., :2], spec, n_gaps=3, gap_len=starts[..., :2])


# ---------------------------------------------------------------- recipe, casts


def test_b128_recipe_matches_the_yaml_config_and_the_recorded_run():
    """``b128_recipe_config`` is ``configs/cnn_blstm_b128.yaml``'s data,
    model and training values (but where the LibriSpeech files lie and how
    many to read) with three gaps a clip, the recipe
    ``results/cnn_b128_bf16_r4_eval.json`` records."""
    import json

    want = Config.from_yaml(os.path.join(REPO, "configs", "cnn_blstm_b128.yaml")).to_dict()
    got = b128_recipe_config().to_dict()
    assert got["data"]["train_n_gaps"] == 3
    want["data"]["train_n_gaps"] = 3
    for d in (want, got):
        for key in ("root_path", "n_files"):
            d["data"].pop(key)
    for section in ("data", "model", "training"):
        assert got[section] == want[section], section
    with open(os.path.join(REPO, "results", "cnn_b128_bf16_r4_eval.json")) as f:
        run = json.load(f)["training"]
    cfg = b128_recipe_config()
    assert (cfg.training.batch_size, cfg.data.gaps_per_audio, cfg.data.train_n_gaps,
            cfg.training.starter_learning_rate) == (run["batch_size"], run["gaps_per_audio"],
                                                    run["train_n_gaps"], run["learning_rate"])


def test_recipe_multi_gap_layouts():
    cfg = b128_recipe_config()
    a = multi_gap_layouts(torch.Generator().manual_seed(5), cfg, 128, 1)
    b = multi_gap_layouts(torch.Generator().manual_seed(5), cfg, 128, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    starts, lengths = a
    assert starts.shape == lengths.shape == (128, 1, 3) and starts.dtype == torch.int64
    _check_guarantees(starts, lengths, cfg.data.max_samples, 160, 3200)


def test_cast_floating_casts_floats_and_passes_the_rest():
    tree = {"w": torch.ones(2, requires_grad=True), "n": torch.arange(3),
            "inner": [torch.zeros(1, dtype=torch.float64), (torch.ones(1), "name")], "k": 3}
    out = cast_floating(tree, torch.bfloat16)
    assert out["w"].dtype == out["inner"][0].dtype == out["inner"][1][0].dtype == torch.bfloat16
    assert out["n"] is tree["n"] and out["k"] == 3 and out["inner"][1][1] == "name"
    assert isinstance(out["inner"], list) and isinstance(out["inner"][1], tuple)
    (out["w"].float() * 3).sum().backward()  # the cast's gradient lands in f32
    assert tree["w"].grad.dtype == torch.float32 and torch.equal(tree["w"].grad, torch.full((2,), 3.0))

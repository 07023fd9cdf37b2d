"""The port's file-in/file-out path against the JAX package's on the CPU:
``cli/inpaint.py`` and ``cli/evaluate.py`` (``gan`` and ``cnn_blstm``),
``runtime/inference.py::route_checkpoint``, ``utils/config.py``'s
``load_config`` and ``gan_profile_config``, ``cli/inpaint.py::_collect`` and
``data/probe.py::load_real_probe_set``.

Both CLIs run in-process on the same FLAC files (the port's with
``--device cpu``).  Most cases use narrow models (``--config`` YAMLs of 1 s
clips; weights drawn with numpy and exported to npz in the JAX package's
format); one case a family runs the committed full-width checkpoint on the
three committed formant FLACs.

What is held, and how close:

* ``inpaint``: the decoded outputs (peak-normalised PCM16) within one LSB of
  each other; inside the gap of the narrow CNN+BiLSTM under ``extrapolate``
  within ``2e-3`` of JAX's gap peak where that is more (the bound of
  ``tests/test_torch_deployable_inference.py``: its random prediction puts
  large magnitudes on quiet bins, whose extrapolated phase the two FFTs
  round apart).  The outputs are not equal bit for bit: both write
  ``restored / peak``, and f32 rounding of ~1e-7 in either (the peak
  included) moves samples across a PCM16 rounding boundary.  Measured: in
  every case 1 to ~360 samples of a 16 000-sample clip one LSB apart, and 2
  LSB at most inside the narrow CNN+BiLSTM's ``extrapolate`` gap.
* ``evaluate``: the JSON files key for key -- the same ``condition`` (and
  ``odg_mapping``), and every per-clip metric within ``2e-3`` of JAX's
  (both are rounded to 3 decimals, so one rounding step apart at most).
* ``--n-gaps 3``: the port draws its layout from a ``torch.Generator``
  seeded 7, JAX from ``PRNGKey(7)``, so the test feeds the port's layout to
  JAX's mask function and metrics and holds the port's JSON to that, within
  ``2e-3``.
* ``--longform`` on a 12 s file: as ``inpaint`` (JAX returns the overlap-add,
  the port composites in time, which differ only by rounding outside the
  gap).
* The phase-mode models, reference ``.pt`` checkpoints and no checkpoint
  (fresh weights) are served; every model and option that the port does
  not have yet raises ``SystemExit`` naming its ROADMAP item.
"""

import argparse
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ml_audio_inpainting_tpu.cli import evaluate as jax_evaluate
from ml_audio_inpainting_tpu.cli import inpaint as jax_inpaint
from ml_audio_inpainting_tpu.cli import soup as jax_soup
from ml_audio_inpainting_tpu.cli import train_refiner as jax_train_refiner
from ml_audio_inpainting_tpu.data import audio_io as jio
from ml_audio_inpainting_tpu.data.probe import load_real_probe_set as jax_probe_set
from ml_audio_inpainting_tpu.models.cnn_blstm import StackedBLSTMCNN as JaxCNN
from ml_audio_inpainting_tpu.runtime import inference as jax_inference
from ml_audio_inpainting_tpu.train import auditory as jax_auditory
from ml_audio_inpainting_tpu.train import metrics as jax_metrics
from ml_audio_inpainting_tpu.train import peaq as jax_peaq
from ml_audio_inpainting_tpu.train.checkpoints import export_params_npz
from ml_audio_inpainting_tpu.train.gan_trainer import build_generator as jax_build_generator
from ml_audio_inpainting_tpu.utils import config as jax_config
from ml_audio_inpainting_torch.cli import evaluate, inpaint, soup, train_refiner
from ml_audio_inpainting_torch.data import multigap
from ml_audio_inpainting_torch.data.probe import load_real_probe_set
from ml_audio_inpainting_torch.models.refiner import WaveRefiner
from ml_audio_inpainting_torch.runtime import inference
from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from ml_audio_inpainting_torch.train.checkpoints import export_params_npz as export_port_npz
from ml_audio_inpainting_torch.utils import config
from torch_threads import one_thread  # noqa: F401  (a module fixture)

REPO = Path(__file__).resolve().parent.parent
FORMANT = REPO / "results" / "formant_corpus_samples"
CKPTS = REPO / "results" / "checkpoints"
METRIC_ATOL = 2e-3
REFINER_GAP_RTOL = 2e-3
REFINER_METRIC_ATOL = 1e-2
ADAPT_PROBE_DB = 2e-2
LSB = 1.0 / 32768
GAN_YAML = {
    "data": {"sample_rate": 16000, "max_len_s": 1.0,
             "spectrogram": {"n_fft": 512, "hop_length": 128, "win_length": 512}},
    "model": {"generator": {"enc_layer_cfg": [[8, 7, 2], [16, 5, 2], [16, 3, 2]],
                            "dec_layer_cfg": [[16, 3, 1], [8, 3, 1]], "final_interim_ch": 8}},
}
CNN_YAML = {
    "data": {"sample_rate": 16000, "max_len_s": 1.0},
    "model": {"num_lstm_layers": 2, "lstm_hidden_dim": 16, "enc_filters": [4, 8],
              "dec_filters": [4, 8]},
}


def _redrawn(variables, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.asarray(
            rng.uniform(0.5, 2.0, p.shape) if str(path[-1].key) == "var"
            else rng.standard_normal(p.shape) * scale, jnp.float32),
        variables,
    )


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """Narrow GAN and CNN+BiLSTM configs and npz weights, and a directory
    of four 1 s FLACs (gap at 0.5 s)."""
    d = tmp_path_factory.mktemp("narrow")
    out = {"dir": d, "clips": d / "clips"}
    for i, clip in enumerate(speech_like_batch(np.random.default_rng(3), 4, 1.0)):
        jio.save_audio(clip * 0.9, out["clips"] / f"clip{i}.flac")
    for name, cfg_dict in (("gan", GAN_YAML), ("cnn_blstm", CNN_YAML)):
        path = d / f"{name}.yaml"
        path.write_text(yaml.safe_dump(cfg_dict))
        jcfg = jax_config.load_config(path)
        if name == "gan":
            net = jax_build_generator(jcfg)
            variables = jax.jit(lambda k, a, m: net.init(k, a, m, train=False))(
                jax.random.PRNGKey(0), jnp.zeros((1, 257, 126)), jnp.ones((1, 257, 126)))
            variables = _redrawn(variables, 0, 0.15)
        else:
            net = JaxCNN(num_lstm_layers=2, lstm_hidden_dim=16, freq_bins=257,
                         enc_filters=(4, 8), dec_filters=(4, 8))
            variables = jax.jit(lambda k, a: net.init(k, a, train=False))(
                jax.random.PRNGKey(0), jnp.zeros((1, 257, 84)))
            variables = _redrawn(variables, 21, 0.2)
        export_params_npz(d / f"{name}.npz", variables)
        out[name] = {"config": str(path), "checkpoint": str(d / f"{name}.npz"), "net": net,
                     "variables": jax.tree_util.tree_map(jnp.asarray, variables), "jcfg": jcfg}
    # The phase-mode model of the narrow CNN+BiLSTM config (2 channels in and out).
    net = JaxCNN(in_channels=2, num_lstm_layers=2, lstm_hidden_dim=16, freq_bins=257,
                 enc_filters=(4, 8), dec_filters=(4, 8))
    variables = jax.jit(lambda k, a: net.init(k, a, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 257, 84, 2)))
    export_params_npz(d / "cnn_phase.npz", _redrawn(variables, 22, 0.2))
    out["cnn_phase"] = str(d / "cnn_phase.npz")
    return out


def _model_args(narrow, model):
    return ["--config", narrow[model]["config"], "--checkpoint", narrow[model]["checkpoint"]]


def _decoded(directory):
    return {p.name: jio.read_audio(p)[0] for p in sorted(Path(directory).glob("*.flac"))}


def _close(g, w, gap=None, gap_rtol=0.0):
    """Two decoded files within one PCM16 LSB; inside ``gap`` (a slice)
    within ``gap_rtol`` of JAX's gap peak where that is larger.  Returns how
    many samples differ at all."""
    g, w = g[:, 0], w[:, 0]
    assert g.shape == w.shape
    atol = np.full(w.shape, LSB * 1.0001)
    if gap is not None:
        atol[gap] = max(LSB * 1.0001, gap_rtol * np.abs(w[gap]).max())
    assert (np.abs(g - w) <= atol).all(), np.abs(g - w).max() / LSB
    return int((g != w).sum())


def _within_one_lsb(got_dir, want_dir, gap=None, gap_rtol=0.0):
    """:func:`_close` on every file of both directories."""
    got, want = _decoded(got_dir), _decoded(want_dir)
    assert sorted(got) == sorted(want) and got
    return sum(_close(got[name], want[name], gap, gap_rtol) for name in got)


# -------------------------------------------------------------- small pieces


@pytest.mark.parametrize("gap_len,ckpt,longgap,threshold", [
    (0.08, "a.npz", "b.npz", 0.25), (0.3, "a.npz", "b.npz", 0.25), (0.25, "a.npz", "b.npz", 0.25),
    (0.3, "a.npz", None, 0.25), (0.3, None, "b.npz", 0.5), (0.6, None, "b.npz", 0.5)])
def test_route_checkpoint_matches_jax(gap_len, ckpt, longgap, threshold):
    assert inference.LONGGAP_THRESHOLD_S == jax_inference.LONGGAP_THRESHOLD_S
    assert (inference.route_checkpoint(gap_len, ckpt, longgap, threshold)
            == jax_inference.route_checkpoint(gap_len, ckpt, longgap, threshold))


def _shared(cfg):
    """The fields both packages' configs have."""
    d = cfg.to_dict()
    model = d["model"]
    return {"data": d["data"], "generator": model["generator"], "cnn_blstm": model["cnn_blstm"],
            "training": {k: d["training"][k] for k in config.TrainingConfig.__dataclass_fields__}}


def _normalised(x):
    return json.loads(json.dumps(x))  # tuples and lists alike


@pytest.mark.parametrize("name", ["gan.yaml", "cnn_blstm.yaml", "cnn_blstm_b128.yaml"])
def test_load_config_matches_jax(name):
    path = REPO / "configs" / name
    got, want = config.load_config(path), jax_config.load_config(path)
    assert _normalised(_shared(got)) == _normalised(_shared(want))
    assert got.data.spectrogram.freq_bins == want.data.spectrogram.freq_bins


@pytest.mark.parametrize("path", [None, "configs/gan.yaml", "configs/cnn_blstm.yaml"])
def test_gan_profile_config_matches_jax(path):
    path = None if path is None else REPO / path
    got, want = config.gan_profile_config(path), jax_config.gan_profile_config(path)
    assert _normalised(_shared(got)) == _normalised(_shared(want))


def test_collect_matches_jax(tmp_path):
    for rel in ("b.flac", "a.WAV", "sub/c.mp3", "sub/deeper/d.flac", "notes.txt", "e.ogg"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    got = inpaint._collect(tmp_path)
    assert got == jax_inpaint._collect(tmp_path)
    assert [p.name for p in got] == ["a.WAV", "b.flac", "c.mp3", "d.flac"]
    assert inpaint._collect(tmp_path / "b.flac") == [tmp_path / "b.flac"]


@pytest.mark.parametrize("positions,gap_len_s", [([0.5, 2.0, 4.95], 0.08), ([1.0], 0.2)])
def test_load_real_probe_set_matches_jax(positions, gap_len_s):
    got = load_real_probe_set(FORMANT, positions, 16000, 5.0, gap_len_s)
    want = jax_probe_set(FORMANT, positions, 16000, 5.0, gap_len_s)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.int32 and got[2] == want[2] == 3


def test_load_real_probe_set_raises_without_files(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_real_probe_set(tmp_path / "missing", [1.0], 16000, 5.0)
    with pytest.raises(FileNotFoundError):
        load_real_probe_set(tmp_path, [1.0], 16000, 5.0)


# -------------------------------------------------------------------- inpaint


@pytest.mark.parametrize("model,extra,gap_rtol", [
    ("gan", ["--mode", "enhanced", "--phase", "extrapolate"], 0.0),
    ("gan", ["--mode", "enhanced", "--phase", "extrapolate", "--tta-shifts", "2"], 0.0),
    ("gan", ["--mode", "parity"], 0.0),
    ("cnn_blstm", ["--phase", "oracle"], 0.0),
    ("cnn_blstm", ["--phase", "extrapolate", "--batch-size", "3"], 2e-3),
], ids=["gan-extrapolate", "gan-tta2", "gan-parity", "cnn-oracle", "cnn-extrapolate-batches"])
def test_inpaint_matches_jax(narrow, tmp_path, model, extra, gap_rtol):
    common = ["--model", model, *_model_args(narrow, model), "--input", str(narrow["clips"]),
              "--gap-start", "0.5", "--gap-len", "0.08", *extra]
    jax_inpaint.main([*common, "--output", str(tmp_path / "jax")])
    inpaint.main([*common, "--output", str(tmp_path / "port"), "--device", "cpu"])
    _within_one_lsb(tmp_path / "port", tmp_path / "jax", slice(8000, 9280), gap_rtol)


def test_inpaint_one_file_to_one_file(narrow, tmp_path):
    clip = narrow["clips"] / "clip1.flac"
    common = ["--model", "cnn_blstm", *_model_args(narrow, "cnn_blstm"), "--input", str(clip),
              "--gap-start", "0.3"]
    jax_inpaint.main([*common, "--output", str(tmp_path / "jax" / "out.flac")])
    inpaint.main([*common, "--output", str(tmp_path / "port" / "out.flac"), "--device", "cpu"])
    _within_one_lsb(tmp_path / "port", tmp_path / "jax")


def test_inpaint_bf16_generator_matches_jax_bf16(narrow, tmp_path):
    """``--infer-dtype bf16``: both run the generator in bf16; within 1e-2
    of the gap's peak (``tests/test_torch_deployable_inference.py``)."""
    common = ["--model", "gan", *_model_args(narrow, "gan"), "--input", str(narrow["clips"]),
              "--gap-start", "0.5", "--mode", "enhanced", "--phase", "extrapolate",
              "--infer-dtype", "bf16"]
    jax_inpaint.main([*common, "--output", str(tmp_path / "jax")])
    inpaint.main([*common, "--output", str(tmp_path / "port"), "--device", "cpu"])
    got, want = _decoded(tmp_path / "port"), _decoded(tmp_path / "jax")
    gap = slice(8000, 8000 + 1280)
    for name in want:
        np.testing.assert_allclose(got[name][gap], want[name][gap], rtol=0,
                                   atol=1e-2 * np.abs(want[name][gap]).max())
        outside = np.ones(len(want[name]), bool)
        outside[gap] = False
        np.testing.assert_allclose(got[name][outside], want[name][outside], rtol=0,
                                   atol=2 * LSB)


def test_inpaint_routes_long_gaps(narrow, tmp_path, capsys):
    """``--checkpoint-longgap`` serves a gap past the threshold with the
    long-gap weights (here the narrow GAN; the standard path does not
    exist, so using it would fail)."""
    args = ["--model", "gan", "--config", narrow["gan"]["config"],
            "--checkpoint", str(tmp_path / "absent.npz"),
            "--checkpoint-longgap", narrow["gan"]["checkpoint"], "--gap-len", "0.3",
            "--gap-start", "0.4", "--mode", "enhanced", "--input", str(narrow["clips"])]
    inpaint.main([*args, "--output", str(tmp_path / "port"), "--device", "cpu"])
    assert "routing to long-gap checkpoint" in capsys.readouterr().out
    jax_inpaint.main([*args, "--output", str(tmp_path / "jax")])
    _within_one_lsb(tmp_path / "port", tmp_path / "jax")


def test_inpaint_longform_matches_jax(narrow, tmp_path):
    """A 12 s file through 1 s windows (hop 0.5 s), the gap at 7.3 s."""
    long = np.concatenate(list(speech_like_batch(np.random.default_rng(8), 12, 1.0)))
    jio.save_audio(long, tmp_path / "in" / "long.flac")
    common = ["--model", "cnn_blstm", *_model_args(narrow, "cnn_blstm"),
              "--input", str(tmp_path / "in"), "--longform", "--gap-start", "7.3",
              "--gap-len", "0.1", "--phase", "extrapolate"]
    jax_inpaint.main([*common, "--output", str(tmp_path / "jax.flac")])
    inpaint.main([*common, "--output", str(tmp_path / "port.flac"), "--device", "cpu"])
    got, want = jio.read_audio(tmp_path / "port.flac")[0], jio.read_audio(tmp_path / "jax.flac")[0]
    assert got.shape == want.shape == (12 * 16000, 1)
    _close(got, want, slice(116800, 118400), 2e-3)


# ------------------------------------------------------------------- evaluate


def _evaluate_both(tmp_path, args):
    jax_evaluate.main([*args, "--output-json", str(tmp_path / "jax.json")])
    evaluate.main([*args, "--output-json", str(tmp_path / "port.json"), "--device", "cpu"])
    return (json.loads((tmp_path / "port.json").read_text()),
            json.loads((tmp_path / "jax.json").read_text()))


def _check_results(got, want, atol=METRIC_ATOL):
    assert got.keys() == want.keys()
    for model in want:
        assert got[model].keys() == want[model].keys()
        for metric, values in want[model].items():
            np.testing.assert_allclose(got[model][metric], values, rtol=0, atol=atol,
                                       err_msg=f"{model} {metric}")


@pytest.mark.parametrize("model,extra", [
    ("gan", ["--mode", "enhanced", "--phase", "extrapolate"]),
    ("gan", ["--mode", "enhanced", "--phase", "griffinlim", "--gl-iters", "4"]),
    ("cnn_blstm", ["--phase", "oracle"]),
    ("cnn_blstm", ["--phase", "extrapolate"]),
], ids=["gan-extrapolate", "gan-griffinlim4", "cnn-oracle", "cnn-extrapolate"])
def test_evaluate_matches_jax(narrow, tmp_path, model, extra):
    args = ["--models", model, *_model_args(narrow, model), "--input", str(narrow["clips"]),
            "--gap-start", "0.5", *extra, "--reconstructions", str(tmp_path / "rec")]
    got, want = _evaluate_both(tmp_path, args)
    assert got["condition"] == want["condition"]
    assert got["condition"]["odg_mapping"] == jax_peaq.ODG_MAPPING
    _check_results(got["results"], want["results"])
    names = sorted(p.name for p in (tmp_path / "rec").glob("*.flac"))
    assert names == [f"clip{i}_{model}_inpainted.flac" for i in range(4)]


@pytest.mark.parametrize("model,ckpt,extra", [
    ("gan", "gan_formant_v2_r2.npz", ["--mode", "enhanced", "--phase", "extrapolate"]),
    ("cnn_blstm", "cnn_blstm_formant_v2_r2.npz", ["--phase", "oracle"]),
], ids=["gan", "cnn_blstm"])
def test_evaluate_committed_checkpoint_matches_jax(tmp_path, model, ckpt, extra):
    args = ["--models", model, "--checkpoint", str(CKPTS / ckpt), "--input", str(FORMANT), *extra]
    got, want = _evaluate_both(tmp_path, args)
    assert got["condition"] == want["condition"]
    assert got["condition"]["files"] == ["formant_0.flac", "formant_1.flac", "formant_2.flac"]
    _check_results(got["results"], want["results"])


@pytest.mark.parametrize("model", ["gan", "cnn_blstm"])
def test_evaluate_n_gaps_matches_jax_on_the_ports_layout(narrow, tmp_path, model):
    extra = ["--mode", "enhanced"] if model == "gan" else []
    args = ["--models", model, *_model_args(narrow, model), "--input", str(narrow["clips"]),
            "--n-gaps", "3", "--phase", "extrapolate", *extra,
            "--output-json", str(tmp_path / "port.json"), "--device", "cpu"]
    evaluate.main(args)
    got = json.loads((tmp_path / "port.json").read_text())
    cond = got["condition"]
    assert cond["n_gaps"] == 3 and cond["min_dist_samples"] == 5000
    assert cond["gap_len_ms_range"] == [10.0, 80.0]

    clean = np.stack([jio.load_audio(f, 16000, 1.0)[0]
                      for f in sorted(narrow["clips"].glob("*.flac"))])
    starts, lengths = multigap.random_multi_gap_layout(
        torch.Generator().manual_seed(evaluate.MULTI_GAP_SEED), (4,), 16000, 3,
        max_gap_ms=80.0, min_dist_samples=5000)
    masks = multigap.gaps_mask(16000, starts, lengths).numpy()
    assert (masks == 0).any(axis=1).all()
    jcfg, net, variables = (narrow[model][k] for k in ("jcfg", "net", "variables"))
    if model == "gan":
        fn = jax_inference.make_gan_inpaint_mask_fn(jcfg, net, mode="enhanced", phase="extrapolate")
    else:
        fn = jax_inference.make_cnn_inpaint_mask_fn(jcfg, net, phase="extrapolate")
    restored = fn(variables, jnp.asarray(clean), jnp.asarray(masks))[0]
    c, g = jnp.asarray(clean), 1.0 - jnp.asarray(masks)
    want = {
        "gap_sdr_db": jax_metrics.gap_sdr(c, restored, g), "snr_db": jax_metrics.snr(c, restored),
        "lsd_db": jax_metrics.log_spectral_distance(c, restored),
        "fwseg_snr_db": jax_metrics.fwseg_snr(c, restored),
        "psm": jax_auditory.psm_score(c, restored), "odg": jax_peaq.odg_score(c, restored),
    }
    want = {k: [round(float(x), 3) for x in np.asarray(v)] for k, v in want.items()}
    _check_results(got["results"], {model: want})


# ------------------------------------------------------------ unported parts


def _inpaint_args(narrow, *extra, model="gan"):
    return ["--model", model, *_model_args(narrow, model), "--input", str(narrow["clips"]),
            "--output", "unused", *extra]


@pytest.mark.parametrize("model", ["refiner", "cnn_phase", "cnn_phase_anchored"])
def test_unported_models_raise(narrow, tmp_path, model):
    """Each model, once refused, is ported.  The ``refiner``: a narrow
    seeded head (C=8) over the narrow GAN through both packages' ``inpaint``
    (within one LSB; inside the gap within 2e-3 of its peak: the AR fill's
    f32 rounding, 5e-4 of its peak in ``tests/test_torch_refiner.py``,
    carried through the random head; measured 5.9e-4) and ``evaluate`` (the
    JSON within ``1e-2``, the same rounding in the metrics, measured 2e-3 on
    one SNR; ``--checkpoint`` is the head's, so neither package evaluates
    the GAN beside it in one call), and both refuse a gap over ``MAX_GAP``,
    ``--n-gaps 2``, ``--longform`` and no ``--checkpoint``.  The phase-mode
    models: a narrow npz through both packages' ``inpaint`` (within one LSB;
    inside the anchored gap within 2e-3 of its peak, the anchor's rounding,
    ``tests/test_torch_phase_cnn.py``) and ``evaluate`` (the JSON within
    ``2e-3``)."""
    if model == "refiner":
        _refiner_parity(narrow, tmp_path)
        return
    common = ["--config", narrow["cnn_blstm"]["config"], "--checkpoint", narrow["cnn_phase"],
              "--input", str(narrow["clips"]), "--gap-start", "0.5"]
    jax_inpaint.main(["--model", model, *common, "--output", str(tmp_path / "jax")])
    inpaint.main(["--model", model, *common, "--output", str(tmp_path / "port"), "--device",
                  "cpu"])
    _within_one_lsb(tmp_path / "port", tmp_path / "jax", slice(8000, 9280),
                    2e-3 if model == "cnn_phase_anchored" else 0.0)
    got, want = _evaluate_both(tmp_path, ["--models", model, *common])
    assert got["condition"] == want["condition"] and "phase" not in got["condition"]
    _check_results(got["results"], want["results"])
    with pytest.raises(SystemExit, match="single-gap"):
        evaluate.main(["--models", model, *common, "--n-gaps", "2", "--device", "cpu"])


@pytest.mark.parametrize("checkpoint", ["orbax_dir", "model.pt", "model.pth", None])
def test_unported_checkpoints_raise(narrow, tmp_path, checkpoint):
    """Once refused, these checkpoints are ported, as the JAX CLI serves
    them: a reference ``.pt``/``.pth`` (a seeded state dict of the narrow
    widths in the reference's layout) through both packages' ``inpaint``
    (within one LSB), and no checkpoint: fresh weights from the port's
    initialiser seeded 0 (JAX draws its own from ``PRNGKey(0)``), the same
    files twice.  A directory that JAX's orbax wrote raises, naming the way
    across (``export_params_npz``)."""
    from test_torch_port_torch import reference_cnn_state_dict

    args = ["--model", "cnn_blstm", "--config", narrow["cnn_blstm"]["config"], "--input",
            str(narrow["clips"]), "--gap-start", "0.5"]
    if checkpoint == "orbax_dir":
        (tmp_path / "orbax_dir" / "3" / "default").mkdir(parents=True)
        (tmp_path / "orbax_dir" / "3" / "_CHECKPOINT_METADATA").write_text("{}")
        with pytest.raises(ValueError, match="export_params_npz"):
            inpaint.main([*args, "--checkpoint", str(tmp_path / checkpoint), "--output",
                          "unused", "--device", "cpu"])
        return
    if checkpoint is None:
        for out in ("one", "two"):
            inpaint.main([*args, "--output", str(tmp_path / out), "--device", "cpu"])
        one, two = _decoded(tmp_path / "one"), _decoded(tmp_path / "two")
        assert sorted(one) == sorted(two) and len(one) == 4
        for name in one:
            np.testing.assert_array_equal(one[name], two[name])
        return
    torch.save(reference_cnn_state_dict(5), tmp_path / checkpoint)
    args += ["--checkpoint", str(tmp_path / checkpoint)]
    jax_inpaint.main([*args, "--output", str(tmp_path / "jax")])
    inpaint.main([*args, "--output", str(tmp_path / "port"), "--device", "cpu"])
    _within_one_lsb(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("extra,match", [
    (["--infer-dtype", "bf16"], "gan only"),
])
def test_unported_inpaint_options_raise(narrow, extra, match):
    with pytest.raises(SystemExit, match=match):
        inpaint.main(_inpaint_args(narrow, *extra, model="cnn_blstm") + ["--device", "cpu"])


@pytest.mark.parametrize("extra,match", [
    (["--adapt-steps", "5", "--n-gaps", "2"], "multi-gap"),
])
def test_unported_evaluate_options_raise(narrow, extra, match):
    """Once refused, these options are ported: ``--golden``
    (``tests/test_torch_golden.py``) and ``--adapt-steps``
    (``test_evaluate_adapt_steps_matches_jax``), which refuses several gaps
    a clip, as JAX's does."""
    with pytest.raises(SystemExit, match=match):
        evaluate.main(["--models", "gan", *_model_args(narrow, "gan"), "--input",
                       str(narrow["clips"]), *extra, "--device", "cpu"])


def _refiner_parity(narrow, tmp_path):
    head = WaveRefiner(channels=8).init_weights(torch.Generator().manual_seed(11))
    with torch.no_grad():
        head.Conv_2.weight.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(12))
    export_port_npz(tmp_path / "head.npz", head)
    common = ["--config", narrow["gan"]["config"], "--gan-config", narrow["gan"]["config"],
              "--gan-checkpoint", narrow["gan"]["checkpoint"], "--checkpoint",
              str(tmp_path / "head.npz"), "--input", str(narrow["clips"]), "--gap-start", "0.5"]
    jax_inpaint.main(["--model", "refiner", *common, "--output", str(tmp_path / "jax")])
    inpaint.main(["--model", "refiner", *common, "--output", str(tmp_path / "port"), "--device",
                  "cpu"])
    _within_one_lsb(tmp_path / "port", tmp_path / "jax", slice(8000, 9280), REFINER_GAP_RTOL)
    got, want = _evaluate_both(tmp_path, ["--models", "refiner", *common])
    assert got["condition"] == want["condition"]
    _check_results(got["results"], want["results"], REFINER_METRIC_ATOL)
    for extra, match in ((["--gap-len", "0.2"], "supports gaps up to 2048"),
                         (["--longform"], "requires a neural model")):
        with pytest.raises(SystemExit, match=match):
            inpaint.main(["--model", "refiner", *common, *extra, "--output", "unused",
                          "--device", "cpu"])
    no_head = [a for a in common if a != str(tmp_path / "head.npz") and a != "--checkpoint"]
    with pytest.raises(SystemExit, match="requires --checkpoint"):
        inpaint.main(["--model", "refiner", *no_head, "--output", "unused", "--device", "cpu"])
    for extra, match in ((["--gap-len", "0.2"], "supports gaps up to"),
                         (["--n-gaps", "2"], "multi-gap")):
        with pytest.raises(SystemExit, match=match):
            evaluate.main(["--models", "refiner", *common, *extra, "--device", "cpu"])


def test_evaluate_adapt_steps_matches_jax(narrow, tmp_path):
    """``evaluate --adapt-steps 2`` in f32 through both packages, on one
    formant FLAC cut to 2.5 s, with the narrow GAN.  The two draw the steps'
    gaps from other streams (``torch.Generator`` and ``jax.random``), so
    the adapted outputs differ; held: the JSON's layout
    (``condition["adapt"]``, the keys of ``adapt_info`` and of each entry,
    the results' keys), ``probe_starts``, the probe steps, and the step-0
    probe score, the unadapted serving path on the AR-filled clip, within
    ``ADAPT_PROBE_DB`` dB (both round to 3 decimals)."""
    clips = tmp_path / "clips"
    clips.mkdir()
    (clips / "formant_0.flac").write_bytes((FORMANT / "formant_0.flac").read_bytes())
    cfg = tmp_path / "gan.yaml"
    cfg.write_text(yaml.safe_dump({**GAN_YAML, "data": {**GAN_YAML["data"], "max_len_s": 2.5}}))
    args = ["--models", "gan", "--config", str(cfg), "--checkpoint",
            narrow["gan"]["checkpoint"], "--mode", "enhanced", "--phase", "extrapolate",
            "--input", str(clips), "--adapt-steps", "2", "--adapt-probe-every", "1",
            "--adapt-batch", "2", "--adapt-n-gaps", "2", "--adapt-lr", "1e-4"]
    got, want = _evaluate_both(tmp_path, args)
    assert got["condition"] == want["condition"]
    assert got["condition"]["adapt"] == {"steps": 2, "lr": 1e-4, "batch": 2, "n_gaps": 2,
                                         "probe_every": 1, "seed": 0}
    assert set(got) == set(want) == {"condition", "results", "adapt_info"}
    assert got["results"].keys() == want["results"].keys()
    assert got["results"]["gan"].keys() == want["results"]["gan"].keys()
    assert got["adapt_info"].keys() == want["adapt_info"].keys() == {"formant_0"}
    g, w = got["adapt_info"]["formant_0"], want["adapt_info"]["formant_0"]
    assert g.keys() == w.keys()
    assert g["probe_starts"] == w["probe_starts"]
    assert [s for s, _ in g["probe_trajectory"]] == [s for s, _ in w["probe_trajectory"]] == [
        0, 1, 2]
    assert abs(g["probe_trajectory"][0][1] - w["probe_trajectory"][0][1]) <= ADAPT_PROBE_DB
    assert g["best_step"] in (0, 1, 2) and g["best_probe_sdr"] >= g["probe_trajectory"][0][1]


def test_cli_flags_are_the_jax_clis_and_device():
    for port, jax_cli in ((inpaint, jax_inpaint), (evaluate, jax_evaluate),
                          (train_refiner, jax_train_refiner)):
        ours = {a.dest for a in port.build_argparser()._actions}
        theirs = {a.dest for a in jax_cli.build_argparser()._actions}
        assert ours == theirs | {"device"}
    ours = {a.dest for a in soup.build_argparser()._actions}
    assert ours == {a.dest for a in jax_soup.build_argparser()._actions}  # host only
    assert inpaint.build_argparser().parse_args(
        ["--model", "gan", "--input", "x", "--output", "y"]).device == "cuda"
    assert train_refiner.build_argparser().parse_args(["--out", "x"]).device == "cuda"
    defaults = evaluate.build_argparser().parse_args(["--models", "gan", "--input", "x"])
    assert isinstance(defaults, argparse.Namespace) and defaults.device == "cuda"

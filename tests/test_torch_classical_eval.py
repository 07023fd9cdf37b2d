"""The port's ``evaluate`` and ``ar_benchmark`` CLIs with the classical
solvers against the JAX package's on the CPU, on the committed formant
FLACs (``test_torch_classical_cli.py`` holds ``inpaint``).

Both CLIs run in-process, the port's with ``--device cpu``, at small
settings (``evaluate`` on 1 s of each clip through ``--config``, ``--ar-order
32 --ar-context 1024 --maxit 2``, a 20 ms gap at 0.5 s).  What is held:

* ``evaluate``'s JSON key for key, with no ``phase`` in a classical-only
  condition, each metric within 2e-3 (one rounding step of the 3 decimals),
  or 0.3 (dB, and PSM/ODG) for ``janssen`` and ``segmentation``, whose f32
  systems are ill-conditioned: each package's f32 result lies up to 0.15 dB
  (gap SDR) from the f64 one, in its own direction;
* ``--n-gaps 3``: the port's layout (a ``torch.Generator`` seeded 7) fed to
  JAX's runner gap after gap, the port's JSON within 2e-3 of that;
* ``ar_benchmark``: the same file names, keys and methods, per-iteration
  lists of the same shape, the values within the bounds above, and a second
  run that skips the file it finds.
"""

import argparse
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ml_audio_inpainting_tpu.cli import ar_benchmark as jax_ar_benchmark
from ml_audio_inpainting_tpu.cli import evaluate as jax_evaluate
from ml_audio_inpainting_tpu.cli import inpaint as jax_inpaint
from ml_audio_inpainting_tpu.train import metrics as jax_metrics
from ml_audio_inpainting_tpu.utils.config import load_config as jax_load_config
from ml_audio_inpainting_torch.cli import ar_benchmark, evaluate
from ml_audio_inpainting_torch.data.multigap import random_multi_gap_layout
from ml_audio_inpainting_torch.utils.config import load_config
from torch_threads import one_thread  # noqa: F401  (a module fixture)

REPO = Path(__file__).resolve().parent.parent
FORMANT = REPO / "results" / "formant_corpus_samples"
SMALL = ["--ar-order", "32", "--ar-context", "1024", "--maxit", "2", "--gap-len", "0.02",
         "--gap-start", "0.5"]
JANSSEN_SDR_DB = 0.3


@pytest.fixture(scope="module")
def short(tmp_path_factory):
    """``--config`` of the default profile on the first 1 s of each clip."""
    path = tmp_path_factory.mktemp("cfg") / "short.yaml"
    path.write_text(yaml.safe_dump({"data": {"sample_rate": 16000, "max_len_s": 1.0}}))
    return ["--config", str(path)]


def _metric_bound(model, key):
    if model in ("janssen", "segmentation"):
        return JANSSEN_SDR_DB if key.endswith("_db") else 0.3
    return 2e-3


def _assert_json_close(got, want):
    assert got.keys() == want.keys()
    assert got["condition"] == want["condition"]
    assert "phase" not in got["condition"]
    assert got["results"].keys() == want["results"].keys()
    for model, metrics in want["results"].items():
        assert got["results"][model].keys() == metrics.keys()
        for key, values in metrics.items():
            np.testing.assert_allclose(got["results"][model][key], values, rtol=0,
                                       atol=_metric_bound(model, key) + 1e-9, err_msg=key)


@pytest.mark.parametrize("models,extra", [
    (["janssen", "arinpaint"], SMALL),
    (["arinpaint", "aspain"], SMALL + ["--ar-preset", "tuned"]),
], ids=["janssen-arinpaint", "tuned"])
def test_evaluate_matches_jax(tmp_path, short, models, extra):
    common = ["--models", *models, "--input", str(FORMANT), *short, *extra]
    jax_evaluate.main([*common, "--output-json", str(tmp_path / "jax.json")])
    evaluate.main([*common, "--output-json", str(tmp_path / "port.json"), "--device", "cpu"])
    _assert_json_close(json.loads((tmp_path / "port.json").read_text()),
                       json.loads((tmp_path / "jax.json").read_text()))


def test_evaluate_n_gaps_solves_gap_after_gap_as_jax(tmp_path, short):
    """``--n-gaps 3`` with a classical solver: the port's layout (seeded 7)
    fed to JAX's runner gap after gap, as JAX's CLI solves them, and to its
    metrics; the port's JSON within 2e-3 of that."""
    argv = ["--models", "arinpaint", "--input", str(FORMANT), "--n-gaps", "3", *short, *SMALL]
    evaluate.main([*argv, "--output-json", str(tmp_path / "port.json"), "--device", "cpu"])
    got = json.loads((tmp_path / "port.json").read_text())["results"]["arinpaint"]

    clean = evaluate.load_clean(sorted(FORMANT.glob("*.flac")), load_config(short[1]))
    gen = torch.Generator().manual_seed(evaluate.MULTI_GAP_SEED)
    starts, lengths = (t.numpy() for t in random_multi_gap_layout(
        gen, (len(clean),), clean.shape[-1], 3, max_gap_ms=20.0,
        min_dist_samples=evaluate.MIN_DIST_SAMPLES))
    idx = np.arange(clean.shape[-1])
    gap = ((idx >= starts[..., None]) & (idx < (starts + lengths)[..., None])).any(1)
    jargs = jax_inpaint.build_argparser().parse_args(
        ["--model", "arinpaint", "--input", "x", "--output", "y", *SMALL])
    runner = jax_inpaint._build_runner(jargs, jax_load_config(short[1]), clean.shape[-1])
    restored = jnp.asarray(clean * ~gap)
    for g in range(3):
        restored = runner(restored, jnp.asarray(starts[:, g]), jnp.asarray(lengths[:, g]))
    want = jax_metrics.gap_sdr(jnp.asarray(clean), restored, jnp.asarray(gap, jnp.float32))
    np.testing.assert_allclose(got["gap_sdr_db"], np.round(np.asarray(want), 3), atol=2e-3)



def test_ar_benchmark_matches_jax(tmp_path):
    argv = ["--input", str(FORMANT / "formant_0.flac"), "--orders", "16", "--estimators",
            "arburg", "--gap-lens-ms", "20", "--maxit", "2", "--w", "1024", "--a", "256"]
    jax_ar_benchmark.main([*argv, "--output-dir", str(tmp_path / "jax")])
    ar_benchmark.main([*argv, "--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.json"))
    assert names == sorted(p.name for p in (tmp_path / "port").glob("*.json")) == [
        "results_p16_arburg_gap20ms.json"]
    for name in names:
        want = json.loads((tmp_path / "jax" / name).read_text())
        got = json.loads((tmp_path / "port" / name).read_text())
        assert got.keys() == want.keys()
        assert {k: v for k, v in got.items() if k != "methods"} == {
            k: v for k, v in want.items() if k != "methods"}
        assert list(got["methods"]) == list(want["methods"]) == list(ar_benchmark.METHODS)
        for method, m in want["methods"].items():
            assert got["methods"][method].keys() == m.keys()
            bound = 2e-3 if method == "extrapolation" else JANSSEN_SDR_DB
            for key in ("gap_sdr_db", "fwseg_snr_db"):
                np.testing.assert_allclose(got["methods"][method][key], m[key], rtol=0,
                                           atol=bound + 1e-9, err_msg=f"{method} {key}")
        per_iter = np.asarray(got["methods"]["janssen"]["gap_sdr_per_iter_db"])
        assert per_iter.shape == np.asarray(want["methods"]["janssen"]["gap_sdr_per_iter_db"]).shape
        assert per_iter[:, -1].tolist() == got["methods"]["janssen"]["gap_sdr_db"]
    # A second run finds every file and skips it.
    before = {p: p.stat().st_mtime_ns for p in (tmp_path / "port").glob("*.json")}
    ar_benchmark.main([*argv, "--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert before == {p: p.stat().st_mtime_ns for p in (tmp_path / "port").glob("*.json")}


def test_ar_benchmark_flags_are_the_jax_clis_and_device():
    ours = {a.dest for a in ar_benchmark.build_argparser()._actions}
    theirs = {a.dest for a in jax_ar_benchmark.build_argparser()._actions}
    assert ours == theirs | {"device"}
    assert isinstance(ar_benchmark.build_argparser().parse_args(["--input", "x"]),
                      argparse.Namespace)

"""``evaluate --golden`` of the port against the JAX package's on the CPU,
both CLIs in-process on the same files (the port's with ``--device cpu``).

The reference's own reconstructions are not in the repository (JAX's
``tests/test_golden_parity.py`` skips without them), so the test writes a
golden directory of its own: for each of three seeded 1 s clips a
``{stem}_gan_inpainted.flac`` and, but for one clip, a
``{stem}_cnnlstm_inpainted.flac`` (the clip with its gap filled by a
seeded, scaled copy of its neighbourhood); one clip is named
``81-121543-0008`` so that ``anchor_check`` is filled.  The check of the
recorded -1.39 and -2.12 dB themselves needs the reference's files and
cannot run here.

What is held, and how close:

* ``condition``, ``recorded_model_comparison``, ``reference_outputs`` and
  ``anchor_check`` equal to JAX's (host numpy on the same decoded files);
* ``ours`` for ``arinpaint`` (order 64, context 2048) and the narrow
  ``gan`` and ``cnn_blstm`` of ``tests/test_torch_cli.py``: the same keys,
  each gap SDR and delta within :data:`GAP_SDR_DB` of JAX's (the 2e-3 of
  ``tests/test_torch_cli.py``'s metrics: one step of the 3-decimal
  rounding), each ``spec_l2_vs_*`` within :data:`SPEC_L2` (1e-4: one step
  of its 4-decimal rounding); measured: arinpaint's gap SDRs 1e-3 apart at
  most, everything else equal to the digits kept;
* ``matlab_gap_slice`` equal to JAX's over a grid of starts and lengths.
"""

import json

import numpy as np
import pytest

from test_torch_cli import narrow  # noqa: F401  (a module fixture)

from ml_audio_inpainting_tpu.cli import evaluate as jax_evaluate
from ml_audio_inpainting_tpu.data import audio_io as jio
from ml_audio_inpainting_torch.cli import evaluate
from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from torch_threads import one_thread  # noqa: F401  (a module fixture)

SR = 16000
GAP_SDR_DB = 2e-3
SPEC_L2 = 1e-4
STEMS = ("81-121543-0008", "clip1", "clip2")
GAP = ["--gap-start", "0.5", "--gap-len", "0.08"]


@pytest.fixture(scope="module")
def golden_dirs(tmp_path_factory):
    """``(clips, golden)``: three 1 s clips and their reconstructions."""
    d = tmp_path_factory.mktemp("golden")
    rng = np.random.default_rng(17)
    clips = speech_like_batch(rng, len(STEMS), 1.0) * 0.7
    gap = slice(7999, 9281)
    for i, (stem, clip) in enumerate(zip(STEMS, clips)):
        jio.save_audio(clip, d / "clips" / f"{stem}.flac", SR, normalize=False)
        for k, tag in enumerate(("gan", "cnnlstm")):
            if tag == "cnnlstm" and i == 2:
                continue  # a reconstruction that is missing is skipped
            rec = clip.copy()
            shift = 160 * (k + 1) + 40 * i
            rec[gap] = rng.uniform(0.3, 0.9) * clip[gap.start - shift:gap.stop - shift]
            jio.save_audio(rec, d / "golden" / f"{stem}_{tag}_inpainted.flac", SR,
                           normalize=False)
    return d / "clips", d / "golden"


def _both(tmp_path, argv):
    jax_evaluate.main([*argv, "--output-json", str(tmp_path / "jax.json")])
    evaluate.main([*argv, "--output-json", str(tmp_path / "port.json"), "--device", "cpu"])
    return (json.loads((tmp_path / "port.json").read_text()),
            json.loads((tmp_path / "jax.json").read_text()))


def _assert_ours_close(got, want):
    assert got.keys() == want.keys()
    for model, entry in want.items():
        assert got[model].keys() == entry.keys()
        for key, value in entry.items():
            bound = SPEC_L2 if key.startswith("spec_l2") else GAP_SDR_DB
            if isinstance(value, dict):
                assert got[model][key].keys() == value.keys(), key
                np.testing.assert_allclose([got[model][key][s] for s in value],
                                           list(value.values()), rtol=0, atol=bound + 1e-9,
                                           err_msg=f"{model} {key}")
            else:
                assert abs(got[model][key] - value) <= bound + 1e-9, (model, key)


@pytest.mark.parametrize("family", ["gan", "cnn_blstm"])
def test_golden_matches_jax(narrow, golden_dirs, tmp_path, family):  # noqa: F811
    clips, golden = golden_dirs
    models = ["arinpaint", "gan"] if family == "gan" else ["cnn_blstm"]
    got, want = _both(tmp_path, [
        "--models", *models, "--config", narrow[family]["config"], "--checkpoint",
        narrow[family]["checkpoint"], "--input", str(clips), "--golden", str(golden), *GAP,
        "--ar-order", "64", "--ar-context", "2048"])
    assert got.keys() == want.keys()
    for key in ("condition", "recorded_model_comparison", "reference_outputs", "anchor_check"):
        assert got[key] == want[key], key
    assert set(got["anchor_check"]) == {"gan", "cnnlstm"}
    assert set(got["reference_outputs"]["cnnlstm"]["gap_sdr_db"]) == set(STEMS[:2])
    _assert_ours_close(got["ours"], want["ours"])
    assert all(np.isfinite(v) for e in got["ours"].values() for v in e["gap_sdr_db"].values())


@pytest.mark.parametrize("sr", [8000, 16000, 44100])
def test_matlab_gap_slice_matches_jax(sr):
    for start in (0.0, 0.5, 1.0, 2.0, 2.37, 3.1):
        for length in (0.01, 0.04, 0.08, 0.1, 0.2, 0.5):
            assert (evaluate.matlab_gap_slice(sr, start, length)
                    == jax_evaluate.matlab_gap_slice(sr, start, length)), (sr, start, length)

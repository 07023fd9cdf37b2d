"""The port's ``inpaint`` CLI with the classical solvers against the JAX
package's on the CPU: each of the eight models and ``--ar-preset tuned``, on
the committed formant FLACs (``test_torch_classical_eval.py`` holds
``evaluate`` and ``ar_benchmark``).

Both CLIs run in-process on the same files, the port's with ``--device
cpu``, at small settings (1 s of each clip through ``--config``,
``--ar-order 32 --ar-context 1024 --maxit 2``, a 20 ms gap at 0.5 s; the
SPAIN solvers run the CLI's 100 iterations, OMP 30; the tuned presets on a
whole 5 s clip at order 128).  What is held, and how close:

* outside the gap, the decoded files within one PCM16 LSB (both write
  ``restored / peak``);
* inside the gap, for the solvers that do not run Janssen, within 3 LSB or
  1e-3 of the gap's peak, whichever is more (measured 2 LSB at order 32; 4
  LSB, 4e-4 of the peak, for the tuned arinpaint's order 512, whose f32
  Levinson rounds more);
* for ``janssen`` and ``segmentation``, each clip's gap SDR within 0.3 dB:
  their f32 systems are ill-conditioned, and on these files each package's
  f32 result lies up to 0.15 dB (gap SDR) from the f64 solution, in its own
  direction (measured; in f64 the packages agree to 1e-11);
"""

from pathlib import Path

import numpy as np
import pytest
import yaml

from ml_audio_inpainting_tpu.cli import inpaint as jax_inpaint
from ml_audio_inpainting_tpu.data import audio_io as jio
from ml_audio_inpainting_torch.cli import inpaint
from ml_audio_inpainting_torch.utils.config import Config
from torch_threads import one_thread  # noqa: F401  (a module fixture)

REPO = Path(__file__).resolve().parent.parent
FORMANT = REPO / "results" / "formant_corpus_samples"
LSB = 1.0 / 32768
SMALL = ["--ar-order", "32", "--ar-context", "1024", "--maxit", "2", "--gap-len", "0.02",
         "--gap-start", "0.5"]
GAP = slice(8000, 8320)
JANSSEN_SDR_DB = 0.3
GAP_LSB = 3
GAP_RTOL = 1e-3


@pytest.fixture(scope="module")
def short(tmp_path_factory):
    """``--config`` of the default profile on the first 1 s of each clip."""
    path = tmp_path_factory.mktemp("cfg") / "short.yaml"
    path.write_text(yaml.safe_dump({"data": {"sample_rate": 16000, "max_len_s": 1.0}}))
    return ["--config", str(path)]


def _decoded(directory):
    return {p.name: jio.read_audio(p)[0][:, 0] for p in sorted(Path(directory).glob("*.flac"))}


def _gap_sdr(clean, x, gap):
    return 10 * np.log10((clean[gap] ** 2).sum() / ((clean[gap] - x[gap]) ** 2).sum())


def _compare(got_dir, want_dir, model, gap):
    got, want = _decoded(got_dir), _decoded(want_dir)
    assert sorted(got) == sorted(want) and got
    for name, w in want.items():
        g = got[name]
        outside = np.ones(len(w), bool)
        outside[gap] = False
        assert np.abs(g - w)[outside].max() <= LSB * 1.0001
        if model in ("janssen", "segmentation"):
            stem = Path(name).stem.split(f"_{model}_")[0]
            clean = jio.read_audio(FORMANT / f"{stem}.flac")[0][: len(w), 0]
            assert abs(_gap_sdr(clean, g, gap) - _gap_sdr(clean, w, gap)) <= JANSSEN_SDR_DB
        else:
            bound = max(GAP_LSB * LSB * 1.0001, GAP_RTOL * np.abs(w[gap]).max())
            assert np.abs(g - w)[gap].max() <= bound


@pytest.mark.parametrize("model", ["janssen", "arinpaint", "segmentation", "aspain", "sspain",
                                   "sspain_omp", "aspain_learned", "sspain_learned"])
def test_inpaint_matches_jax(tmp_path, short, model):
    # 1 s of each clip; the windowed and SPAIN solvers on one file.
    one = model not in ("janssen", "arinpaint")
    inp = FORMANT / "formant_1.flac" if one else FORMANT
    common = ["--model", model, "--input", str(inp), *short, *SMALL]
    out = (lambda d: d / "formant_1.flac") if one else (lambda d: d)
    if one:
        (tmp_path / "jax").mkdir()
        (tmp_path / "port").mkdir()
    jax_inpaint.main([*common, "--output", str(out(tmp_path / "jax"))])
    inpaint.main([*common, "--output", str(out(tmp_path / "port")), "--device", "cpu"])
    _compare(tmp_path / "port", tmp_path / "jax", model, GAP)


@pytest.mark.parametrize("model,extra", [
    ("arinpaint", []),
    ("janssen", ["--ar-order", "128"]),
    ("janssen", ["--ar-order", "128", "--gap-len", "0.2"]),
], ids=["arinpaint", "janssen", "janssen-200ms"])
def test_inpaint_tuned_preset_matches_jax(tmp_path, capsys, model, extra):
    # Full 5 s clips: the tuned contexts reach 16384 samples each side.
    common = ["--model", model, "--input", str(FORMANT / "formant_0.flac"), "--ar-preset",
              "tuned", *extra]
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    jax_inpaint.main([*common, "--output", str(tmp_path / "jax" / "formant_0.flac")])
    want_log = capsys.readouterr().err
    inpaint.main([*common, "--output", str(tmp_path / "port" / "formant_0.flac"), "--device",
                  "cpu"])
    got_log = capsys.readouterr().err
    assert "--ar-preset tuned" in got_log and got_log == want_log
    gap_len = int(0.2 * 16000) if "0.2" in extra else 1280
    _compare(tmp_path / "port", tmp_path / "jax", model, slice(32000, 32000 + gap_len))


def test_tuned_preset_overrides_the_flags():
    args = inpaint.build_argparser().parse_args(
        ["--model", "arinpaint", "--input", "x", "--output", "y", "--ar-preset", "tuned",
         "--ar-order", "64", "--device", "cpu"])
    inpaint._build_runner(args, Config())
    assert (args.ar_order, args.ar_context, args.ar_blend, args.ar_blend_param) == (
        512, 8192, "sigmoid", 2.0)


def test_longform_needs_a_neural_model():
    with pytest.raises(SystemExit, match="neural model"):
        inpaint.main(["--model", "arinpaint", "--input", str(FORMANT), "--output", "unused",
                      "--longform", "--device", "cpu"])

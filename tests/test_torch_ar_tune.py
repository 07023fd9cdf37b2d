"""The port's ``cli/ar_tune.py`` against the JAX package's on the CPU, at the
settings of JAX's own test (``tests/test_ar_tune.py``: sine-mix probe clips
of 4 s, a 40 ms gap, order 64, contexts 1024 and 2048), both in-process on
the same files (the port's with ``--device cpu``).

What is held: the same grid rows in the same order with the same settings;
the same winner; the Janssen grid's ``maxit``; ``--eval`` with an explicit
``--input``, and without one a refusal.  Each row's ``probe_mean_db``:

* arinpaint, within :data:`PROBE_DB` (0.01 dB) of JAX's, and ``--eval``'s
  score too (measured: 3e-3 dB at most, three steps of the rows' 3
  decimals);
* Janssen, within :data:`JANSSEN_F32_DB` (2 dB) of JAX's.  Its f32 systems
  on these two-sine clips are ill-conditioned: in f64 the two packages give
  the same score to 3 decimals (22.593 and 27.408 dB for 1 and 2
  iterations), while each package's f32 score lies up to 1.7 dB from it in
  its own direction (JAX 24.313 and 27.706, the port 23.251 and 26.193:
  1.06 and 1.51 dB apart).  So each grid point's solver, as the port's CLI
  builds it (``ar_tune.solver``), is also run in f64 on the probe set and
  held within 1e-9 of the gap's peak of JAX's solver in f64, the bound of
  ``tests/test_torch_janssen.py``.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.cli import ar_tune as jax_ar_tune
from ml_audio_inpainting_tpu.cli.inpaint import _build_runner as jax_build_runner
from ml_audio_inpainting_tpu.data.audio_io import save_audio
from ml_audio_inpainting_tpu.utils.config import Config as JaxConfig
from ml_audio_inpainting_torch.cli import ar_tune
from ml_audio_inpainting_torch.data.probe import load_real_probe_set
from ml_audio_inpainting_torch.utils.config import Config
from torch_threads import one_thread  # noqa: F401  (a module fixture)

PROBE_DB = 1e-2
JANSSEN_F32_DB = 2.0
F64_RTOL = 1e-9


def _make_clips(d, n=2, seconds=4.0, sr=16000):
    """``tests/test_ar_tune.py::_make_clips``."""
    d.mkdir(exist_ok=True)
    t = np.arange(int(seconds * sr)) / sr
    for i in range(n):
        sig = (0.4 * np.sin(2 * np.pi * (220 + 60 * i) * t)
               + 0.1 * np.sin(2 * np.pi * (880 + 30 * i) * t)).astype(np.float32)
        save_audio(sig, d / f"p{i}.flac", sr, normalize=False)


def _both(tmp_path, argv):
    jax_ar_tune.main([*argv, "--output-json", str(tmp_path / "jax.json")])
    out = ar_tune.main([*argv, "--output-json", str(tmp_path / "port.json"), "--device", "cpu"])
    got = json.loads((tmp_path / "port.json").read_text())
    assert got == json.loads(json.dumps(out))
    return got, json.loads((tmp_path / "jax.json").read_text())


def _assert_rows_close(got, want, bound=PROBE_DB):
    assert got.keys() == want.keys()
    assert got["what"] == want["what"] and got["protocol"] == want["protocol"]
    assert len(got["grid"]) == len(want["grid"])
    for g, w in zip(got["grid"], want["grid"]):
        assert g.keys() == w.keys()
        assert {k: v for k, v in g.items() if k not in ("probe_mean_db", "elapsed_s")} == {
            k: v for k, v in w.items() if k not in ("probe_mean_db", "elapsed_s")}
        assert np.isfinite(g["probe_mean_db"])
        assert abs(g["probe_mean_db"] - w["probe_mean_db"]) <= bound + 1e-9, (g, w)
    best = lambda d: {k: v for k, v in d["probe_best"].items() if k != "probe_mean_db"}  # noqa: E731
    assert best(got) == best(want)
    assert got["probe_best"]["probe_mean_db"] == max(r["probe_mean_db"] for r in got["grid"])


def test_arinpaint_sweep_and_eval_match_jax(tmp_path):
    _make_clips(tmp_path / "probe")
    _make_clips(tmp_path / "eval", n=1, seconds=3.0)
    got, want = _both(tmp_path, [
        "--model", "arinpaint", "--gap-len", "0.04",
        "--probe-dir", str(tmp_path / "probe"), "--probe-positions", "1.0", "2.0",
        "--contexts", "1024", "2048", "--orders", "64", "--blends", "cos2", "sigmoid:2",
        "--eval", "--input", str(tmp_path / "eval"), "--gap-start", "1.5",
    ])
    assert len(got["grid"]) == 4
    _assert_rows_close(got, want)
    assert got["eval"]["files"] == want["eval"]["files"] == ["p0.flac"]
    assert got["eval"]["gap_start_s"] == want["eval"]["gap_start_s"]
    assert abs(got["eval"]["mean_gap_sdr_db"] - want["eval"]["mean_gap_sdr_db"]) <= PROBE_DB + 1e-9


def test_janssen_grid_uses_maxit_as_jax(tmp_path):
    _make_clips(tmp_path / "probe", n=1)
    argv = ["--model", "janssen", "--gap-len", "0.04", "--probe-dir", str(tmp_path / "probe"),
            "--probe-positions", "1.5", "--contexts", "1024", "--orders", "64", "--maxits", "1",
            "2"]
    got, want = _both(tmp_path, argv)
    assert [r["maxit"] for r in got["grid"]] == [r["maxit"] for r in want["grid"]] == [1, 2]
    _assert_rows_close(got, want, JANSSEN_F32_DB)

    # The same solvers in f64: the port's as its CLI builds them, JAX's as its CLI does.
    args = ar_tune.build_argparser().parse_args([*argv, "--device", "cpu"])
    clips, starts, _ = load_real_probe_set(tmp_path / "probe", [1.5], 16000, 5.0, 0.04)
    gl = np.full_like(starts, 640)
    gap = np.zeros(clips.shape, bool)
    for i, s in enumerate(starts):
        gap[i, s:s + 640] = True
    for conf in ar_tune.grid(args):
        port = ar_tune.solver(args, conf, Config())(
            torch.tensor(clips, dtype=torch.float64), torch.tensor(starts),
            torch.tensor(gl)).numpy()
        with jax.enable_x64(True):
            runner = jax_build_runner(argparse.Namespace(
                model="janssen", gap_len=0.04, ar_method="lpc", config=None, checkpoint=None,
                infer_dtype="f32", **conf), JaxConfig(), clips.shape[-1])
            want_f64 = np.asarray(runner(jnp.asarray(clips, jnp.float64), jnp.asarray(starts),
                                         jnp.asarray(gl)))
        assert port.dtype == want_f64.dtype == np.float64
        err = np.abs(port - want_f64)[gap].max() / np.abs(want_f64[gap]).max()
        assert err <= F64_RTOL, (conf, err)


def test_eval_without_input_raises(tmp_path):
    with pytest.raises(SystemExit, match="--input"):
        ar_tune.main(["--gap-len", "0.04", "--probe-dir", str(tmp_path), "--eval", "--device",
                      "cpu"])

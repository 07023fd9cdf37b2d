"""The port's ``cli/ar_plots.py`` on the CPU, on the results of the port's
``cli/ar_benchmark.py`` at the settings of JAX's own test
(``tests/test_benchmark_cli.py::test_plots``: two 3 s sine clips, order
32, lpc, a 40 ms gap, 2 Janssen iterations, w 1024, a 256).

What is held: each method's series (orders, mean, lo, hi) equal to JAX's
``utils/stats.py::bootstrap_ci`` on the same JSON values (exactly: both are
numpy with the same seed), the JAX CLI's main figure from the same
directory, and the three PNGs (main, ``--per-iteration``, ``--scatter``)
written.  The test needs matplotlib and skips without it; the card's machine has none.
"""

from pathlib import Path

import numpy as np
import pytest

from ml_audio_inpainting_tpu.data.audio_io import save_audio
from ml_audio_inpainting_tpu.utils.stats import bootstrap_ci as jax_bootstrap_ci
from ml_audio_inpainting_torch.cli import ar_benchmark, ar_plots
from torch_threads import one_thread  # noqa: F401  (a module fixture)

pytest.importorskip("matplotlib")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """``tests/test_benchmark_cli.py::eval_clips`` through the port's
    ``ar_benchmark`` at that test's settings."""
    d = tmp_path_factory.mktemp("ar_plots")
    t = np.arange(48000) / 16000
    for i in range(2):
        sig = 0.4 * np.sin(2 * np.pi * (250 + 80 * i) * t).astype(np.float32)
        save_audio(sig, d / "clips" / f"clip{i}.flac", 16000, normalize=False)
    ar_benchmark.main(["--input", str(d / "clips"), "--output-dir", str(d / "results"),
                       "--orders", "32", "--estimators", "lpc", "--gap-lens-ms", "40",
                       "--maxit", "2", "--w", "1024", "--a", "256", "--device", "cpu"])
    return d / "results"


def test_series_match_jax_bootstrap(results):
    entries = ar_plots.load_results(results)
    series = ar_plots.method_series(entries, "gap_sdr_db")
    assert sorted(series) == sorted(entries[0]["methods"]) == list(series)
    for method, (orders, means, los, his) in series.items():
        assert orders == [32]
        values = np.asarray(entries[0]["methods"][method]["gap_sdr_db"])
        assert len(values) == 2 and np.all(np.isfinite(values))
        mean, lo, hi = jax_bootstrap_ci(values[:, None])
        assert (means, los, his) == ([float(mean[0])], [float(lo[0])], [float(hi[0])]), method
    assert ar_plots.method_series(entries, "gap_sdr_db", estimator="arburg") == {}


def test_figures_written(results, tmp_path):
    from ml_audio_inpainting_tpu.cli.ar_plots import main as jax_main

    png = tmp_path / "plot.png"
    written = ar_plots.main(["--results-dir", str(results), "--output", str(png),
                             "--per-iteration", "--scatter", "janssen", "extrapolation"])
    assert written == [png, png.with_suffix(".scatter.png"), png.with_suffix(".iters.png")]
    for p in written:
        assert p.exists() and p.stat().st_size > 1000, p
    jax_main(["--results-dir", str(results), "--output", str(tmp_path / "jax.png")])
    assert (tmp_path / "jax.png").stat().st_size > 1000


def test_empty_results_dir_raises(tmp_path):
    with pytest.raises(SystemExit, match="results_"):
        ar_plots.load_results(Path(tmp_path))

"""The port's ``utils/tb_analysis.py`` against the JAX package's on the
CPU: scalar events written by ``torch.utils.tensorboard.SummaryWriter``
into two run directories whose steps overlap (a resumed run), read by both
packages' ``load_scalar_runs`` (equal, exactly: the same reader, merged and
de-duplicated in numpy), ``smooth`` (equal, exactly) and ``plot_runs``
(a figure, or a file when given a path).  Skips where tensorboard or
matplotlib is missing (the card's machine has neither)."""

import numpy as np
import pytest

pytest.importorskip("tensorboard")
pytest.importorskip("matplotlib")

from torch.utils.tensorboard import SummaryWriter  # noqa: E402

from ml_audio_inpainting_tpu.utils import tb_analysis as jax_tb  # noqa: E402
from ml_audio_inpainting_torch.utils import tb_analysis  # noqa: E402
from torch_threads import one_thread  # noqa: E402, F401  (a module fixture)

TAG = "loss/g_total"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two runs of one tag, the second resumed at step 30 over the first's
    steps 30-39 with other values; a third run without the tag."""
    d = tmp_path_factory.mktemp("tb")
    rng = np.random.default_rng(8)
    for name, steps in (("run_a", range(0, 40)), ("run_b", range(30, 70))):
        with SummaryWriter(str(d / name)) as w:
            for s in steps:
                w.add_scalar(TAG, float(np.exp(-s / 30) + 0.05 * rng.standard_normal()), s)
            w.add_scalar("other", 1.0, 0)
    with SummaryWriter(str(d / "run_c")) as w:
        w.add_scalar("other", 2.0, 0)
    return [d / "run_a", d / "run_b", d / "run_c"]


def test_load_scalar_runs_matches_jax(runs):
    for dirs in (runs, runs[::-1], runs[:1], runs[2:]):
        got, want = tb_analysis.load_scalar_runs(dirs, TAG), jax_tb.load_scalar_runs(dirs, TAG)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    steps, _ = tb_analysis.load_scalar_runs(runs, TAG)
    np.testing.assert_array_equal(steps, np.arange(70))


@pytest.mark.parametrize("weight", [0.0, 0.5, 0.9, 0.95])
def test_smooth_matches_jax(runs, weight):
    _, values = tb_analysis.load_scalar_runs(runs, TAG)
    for x in (values, np.asarray([0.0, 1.0, 1.0, 1.0]), np.full(10, 3.0, np.float32)):
        got, want = tb_analysis.smooth(x, weight), jax_tb.smooth(x, weight)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)


def test_plot_runs_figure_or_file(runs, tmp_path):
    import matplotlib.pyplot as plt

    fig = tb_analysis.plot_runs({"a+b": runs[:2], "c": runs[2:]}, TAG, title="t")
    assert fig is not None and len(fig.axes[0].lines) == 1
    plt.close(fig)
    out = tmp_path / "runs.png"
    assert tb_analysis.plot_runs({"a+b": runs[:2]}, TAG, save_path=out) is None
    assert out.exists() and out.stat().st_size > 1000

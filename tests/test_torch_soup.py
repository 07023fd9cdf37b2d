"""Model soups and bootstrap intervals in the port (``cli/soup.py``,
``utils/stats.py``) against the JAX package's: both are host numpy, so the
outputs are held bit for bit, on the committed refiner head and a seeded
perturbation of it, and on seeded data.  Every refusal of JAX's
``soup_params`` is the port's too.
"""

import numpy as np
import pytest

from ml_audio_inpainting_tpu.cli import soup as jax_soup
from ml_audio_inpainting_tpu.utils import stats as jax_stats
from ml_audio_inpainting_torch.cli import soup
from ml_audio_inpainting_torch.utils import stats
from ml_audio_inpainting_torch.weights import load_params_npz

from test_torch_refiner import HEAD, flatten
from torch_threads import one_thread  # noqa: F401  (a module fixture)


def _perturbed(tmp_path, seed=0, scale=0.01):
    rng = np.random.default_rng(seed)
    flat = {k: (v + scale * rng.standard_normal(v.shape)).astype(np.float16)
            for k, v in load_params_npz(HEAD).items()}
    path = tmp_path / f"perturbed{seed}.npz"
    np.savez_compressed(path, **flat)
    return path


@pytest.mark.parametrize("weights,dtype", [(None, "float16"), ([0.25, 0.75], "float32"),
                                           ([1.0, 2.0, 5.0], "float16")],
                         ids=["uniform-f16", "weighted-f32", "three-f16"])
def test_soup_cli_is_jaxs_bit_for_bit(tmp_path, weights, dtype):
    inputs = [str(HEAD), str(_perturbed(tmp_path))]
    if weights and len(weights) == 3:
        inputs.append(str(_perturbed(tmp_path, seed=1, scale=0.05)))
    extra = (["--weights", *map(str, weights)] if weights else []) + ["--dtype", dtype]
    soup.main([str(tmp_path / "port.npz"), *inputs, *extra])
    jax_soup.main([str(tmp_path / "jax.npz"), *inputs, *extra])
    with np.load(tmp_path / "port.npz") as got, np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files) and len(got.files) == 78
        for k in want.files:
            assert got[k].dtype == want[k].dtype == np.dtype(dtype), k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_soup_params_is_jaxs_bit_for_bit_on_float_and_int_leaves(tmp_path):
    a = load_params_npz(HEAD)
    b = load_params_npz(_perturbed(tmp_path, 2, 0.1))
    a["step"], b["step"] = np.int32(7), np.int32(7)
    got = soup.soup_params([a, b], [0.3, 0.7])
    want = flatten(jax_soup.soup_params([{k: v for k, v in a.items()},
                                         {k: v for k, v in b.items()}], [0.3, 0.7]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["step"], 7)


def _refusals(a, b):
    c = dict(b)
    c["params/Conv_0/bias"] = np.zeros(3, np.float32)
    d = dict(b)
    d.pop("params/Conv_2/bias")
    e1, e2 = dict(a), dict(b)
    e1["count"], e2["count"] = np.int32(1), np.int32(2)
    return [
        ([a], None, "at least two"),
        ([a, b], [1.0], "1 weights for 2 inputs"),
        ([a, b], [1.0, -0.5], "non-negative"),
        ([a, b], [0.0, 0.0], "positive"),
        ([a, c], None, "shape mismatch"),
        ([a, d], None, "structure"),
        ([e1, e2], None, "non-float leaves differ"),
    ]


@pytest.mark.parametrize("case", range(7))
def test_soup_refuses_what_jax_refuses(tmp_path, case):
    a = load_params_npz(HEAD)
    b = load_params_npz(_perturbed(tmp_path, 3))
    trees, weights, match = _refusals(a, b)[case]
    with pytest.raises(ValueError, match=match):
        soup.soup_params(trees, weights)
    with pytest.raises(ValueError, match=match):
        jax_soup.soup_params([dict(t) for t in trees], weights)


def test_soup_flags_are_jaxs():
    ours = {a.dest for a in soup.build_argparser()._actions}
    theirs = {a.dest for a in jax_soup.build_argparser()._actions}
    assert ours == theirs


@pytest.mark.parametrize("shape,n_boot,alpha,seed", [
    ((40,), 1000, 0.05, 0), ((25, 3), 500, 0.1, 7), ((9, 2, 2), 200, 0.05, 3), ((1, 4), 100, 0.05, 0),
    ((12,), 300, 0.05, 1)])
def test_bootstrap_ci_is_jaxs_bit_for_bit(shape, n_boot, alpha, seed):
    data = np.random.default_rng(seed).standard_normal(shape) * 2.0 + 1.0
    if shape == (12,):
        data[:] = 3.0  # zero spread: the 1e-12 guard
    got = stats.bootstrap_ci(data, n_boot=n_boot, alpha=alpha, seed=seed)
    want = jax_stats.bootstrap_ci(data, n_boot=n_boot, alpha=alpha, seed=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    mean, lo, hi = got
    assert np.all(lo <= mean + 1e-12) and np.all(mean <= hi + 1e-12)


def test_interval_plots_need_matplotlib():
    try:
        import matplotlib
    except ImportError:
        assert stats.fill_interval(None, [0, 1], [0, 1], [0, 0], [1, 1]) is None
        assert stats.plot_interval(None, [0, 1], [0, 1], [0, 0], [1, 1]) is None
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    assert stats.fill_interval(ax, [0, 1], [0, 1], [0, 0], [1, 1]) is not None
    assert stats.plot_interval(ax, [0, 1], [0, 1], [0, 0], [1, 1]) is not None
    plt.close(fig)

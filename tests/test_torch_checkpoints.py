"""The port's training checkpoints and run plumbing on the CPU:
``train/checkpoints.py::CheckpointManager`` (round trips of the CNN+BiLSTM
and GAN train states bit for bit, idempotent saves, the save interval,
``max_to_keep``, a save cut short, an orbax directory refused, a template
that does not match), ``utils/config.py`` against the JAX package's
``load_config`` on every ``configs/*.yaml`` and on a JSON copy of each,
``utils/run_logging.py::RunContext`` and ``utils/visualize.py``.

The states are tiny (the CNN+BiLSTM of ``tests/test_torch_cnn_train.py``'s
config, the GAN of ``tests/test_gan.py::tiny_gan_config``) and have taken
one or two steps, so Adam's moments and step counts, the EMA, BatchNorm's
running statistics and the PatchGAN's ``u`` and ``sigma`` are all away from
their initial values when saved.
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from ml_audio_inpainting_tpu.utils import config as jax_config
from ml_audio_inpainting_torch.train import checkpoints as ckpt_mod
from ml_audio_inpainting_torch.train.checkpoints import CheckpointManager, state_tree
from ml_audio_inpainting_torch.train.cnn_trainer import create_cnn_state, make_cnn_train_step
from ml_audio_inpainting_torch.train.gan_trainer import create_gan_states, make_gan_train_step
from ml_audio_inpainting_torch.utils import config
from ml_audio_inpainting_torch.utils.run_logging import RunContext, config_text
from ml_audio_inpainting_torch.utils.visualize import visualize_spectrogram
from test_gan import tiny_gan_config
from test_torch_cnn_train import _audio, _cfg_dict
from torch_threads import one_thread  # noqa: F401  (a module fixture)

REPO_CONFIGS = ["cnn_blstm.yaml", "cnn_blstm_b128.yaml", "gan.yaml"]


def _cnn_state(steps=1, seed=0):
    cfg = config.Config.from_dict(_cfg_dict(lr_decay=0.5))
    state = create_cnn_state(cfg, device="cpu", ema=0.9, seed=seed)
    step = make_cnn_train_step(cfg, ema=0.9)
    gen = torch.Generator().manual_seed(seed)
    for i in range(steps):
        state, _ = step(state, torch.tensor(_audio(i)),
                        torch.randint(0, 7000, (2, 2), generator=gen))
    return cfg, state


def _gan_states(steps=1):
    cfg = config.Config.from_dict(json.loads(json.dumps(tiny_gan_config().to_dict())))
    g, d = create_gan_states(cfg, device="cpu", g_ema=0.9)
    step = make_gan_train_step(cfg, g_ema=0.9)
    for i in range(steps):
        audio = torch.tensor(np.random.default_rng(i).standard_normal((2, 16000)),
                             dtype=torch.float32)
        g, d, _ = step(g, d, audio, torch.tensor([3000, 9000]))
    return cfg, {"g": g, "d": d}


def _assert_trees_equal(got, want, path="state"):
    if torch.is_tensor(want):
        assert torch.is_tensor(got) and got.dtype == want.dtype, path
        assert torch.equal(got.cpu(), want.cpu()), path
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_trees_equal(a, b, f"{path}/{i}")
    else:
        assert got == want, path


def test_cnn_state_round_trip_bit_for_bit(tmp_path):
    cfg, state = _cnn_state(steps=2)
    assert state.step == 2 and state.optimizer.state
    mgr = CheckpointManager(tmp_path / "run", max_to_keep=3)
    assert mgr.save(2, state) and mgr.latest_step() == 2
    _, fresh = _cnn_state(steps=0, seed=1)
    restored = mgr.restore(fresh)
    assert restored is fresh and fresh.step == 2
    _assert_trees_equal(state_tree(fresh), state_tree(state))
    assert fresh.scheduler.get_last_lr() == state.scheduler.get_last_lr()
    # The restored state trains on exactly as the saved one does.
    step = make_cnn_train_step(cfg, ema=0.9)
    starts = torch.tensor([[1000, 5000], [3000, 6500]])
    for s in (state, fresh):
        step(s, torch.tensor(_audio(9)), starts)
    _assert_trees_equal(state_tree(fresh), state_tree(state))


def test_gan_state_round_trip_bit_for_bit(tmp_path):
    """``{"g", "d"}`` as the CLI saves it: G's parameters, running
    statistics, Adam and EMA; D's parameters, Adam and spectral-norm ``u``
    and ``sigma`` buffers."""
    _, states = _gan_states(steps=1)
    disc = states["d"].model
    assert not torch.equal(disc.block0_conv.sigma, torch.ones(()))
    mgr = CheckpointManager(tmp_path / "gan")
    mgr.save(1, states)
    _, fresh = _gan_states(steps=0)
    mgr.restore(fresh)
    _assert_trees_equal(state_tree(fresh), state_tree(states))
    assert torch.equal(fresh["d"].model.block0_conv.u, disc.block0_conv.u)


def test_save_is_idempotent_and_keeps_the_interval_and_max_to_keep(tmp_path):
    _, state = _cnn_state(steps=1)
    mgr = CheckpointManager(tmp_path, max_to_keep=2, save_interval_steps=4)
    assert mgr.save(3, state)  # the first save is always taken
    assert not mgr.save(3, state, force=True)  # a step already saved is skipped
    assert not mgr.save(2, state)  # not past the latest
    assert not mgr.save(5, state)  # not on the interval
    assert mgr.save(8, state)
    assert mgr.save(9, state, force=True)  # force takes any later step
    assert mgr.all_steps() == [8, 9]  # max_to_keep 2
    assert mgr.load_tree(8)["step"] == 1
    with pytest.raises(FileNotFoundError):
        mgr.load_tree(3)


def test_a_cut_save_never_stands_as_a_step(tmp_path, monkeypatch):
    _, state = _cnn_state(steps=1)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, state)

    def cut(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise KeyboardInterrupt("cut")

    monkeypatch.setattr(ckpt_mod.torch, "save", cut)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(2, state)
    assert mgr.latest_step() == 1 and sorted(p.name for p in tmp_path.iterdir()) == ["1"]
    assert mgr.load_tree()["step"] == 1


def test_orbax_directory_and_mismatched_templates_are_refused(tmp_path):
    orbax = tmp_path / "orbax"
    (orbax / "5" / "default").mkdir(parents=True)
    (orbax / "5" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="export_params_npz"):
        CheckpointManager(orbax)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").load_tree()

    cfg, state = _cnn_state(steps=1)
    mgr = CheckpointManager(tmp_path / "run")
    mgr.save(1, state)
    no_ema = create_cnn_state(cfg, device="cpu")
    no_ema.scheduler = state.scheduler  # only the EMA differs
    with pytest.raises(ValueError, match="EMA"):
        mgr.restore(no_ema)
    wider = config.Config.from_dict(_cfg_dict(lr_decay=0.5))
    wider.model.cnn_blstm.lstm_hidden_dim = 8
    with pytest.raises(ValueError, match="checkpoint"):
        mgr.restore(create_cnn_state(wider, device="cpu", ema=0.9))


def _normalised(cfg):
    return json.loads(json.dumps(cfg.to_dict()))  # tuples and lists alike


@pytest.mark.parametrize("name", REPO_CONFIGS)
@pytest.mark.parametrize("as_json", [False, True], ids=["yaml", "json"])
def test_config_matches_jax_load_config(tmp_path, name, as_json):
    """Every section (paths, logging, mesh and the resume keys included),
    from the YAML file and from a JSON copy, which the port parses with
    ``json`` (no YAML package) and the JAX package with ``yaml``."""
    path = Path(__file__).resolve().parent.parent / "configs" / name
    if as_json:
        tree = yaml.safe_load(path.read_text())
        path = tmp_path / (name[:-5] + ".json")
        path.write_text(json.dumps(tree))
    got, want = config.load_config(path), jax_config.load_config(path)
    assert _normalised(got) == _normalised(want)
    assert config.Config.from_dict(want.to_dict()).to_dict() == got.to_dict()


def test_json_config_needs_no_yaml(tmp_path, monkeypatch):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"logging": {"metric_interval": 3}, "paths": {"log_dir": "l"},
                                "mesh": {"model_parallel": 2}, "training": {"batch_size": 5}}))
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml now fails
    cfg = config.load_config(path)
    assert (cfg.logging.metric_interval, cfg.paths.log_dir, cfg.mesh.model_parallel,
            cfg.training.batch_size) == (3, "l", 2, 5)
    assert json.loads(config_text(cfg)) == json.loads(json.dumps(cfg.to_dict()))


def test_run_context_dirs_log_and_config_dump(tmp_path):
    cfg = config.Config()
    cfg.paths.sample_dir = "s"
    run = RunContext(cfg, run_name="t", base_dir=str(tmp_path))
    assert run.run_name.startswith("t_")
    for d in (run.checkpoint_dir, run.log_dir, run.sample_dir, run.tb_dir):
        assert d.is_dir()
    assert run.sample_dir == tmp_path / "s" / run.run_name
    run.logger.info("hello")
    run.scalar("x", 1.0, 1)
    run.close()
    text = (run.log_dir / f"{run.run_name}.log").read_text()
    assert "hello" in text and "metric_interval: 25" in text
    shutil.rmtree(tmp_path)


def test_visualize_spectrogram(tmp_path, monkeypatch):
    spec = np.abs(np.random.default_rng(0).standard_normal((33, 20))).astype(np.float32)
    fig = visualize_spectrogram(torch.tensor(spec), hop_length=128, gap_int=(0.1, 0.2))
    assert fig is not None and fig.axes[0].get_title() == "Spectrogram"
    assert visualize_spectrogram(spec, save_path=tmp_path / "a" / "s.png") is None
    assert (tmp_path / "a" / "s.png").stat().st_size > 0
    with pytest.raises(ValueError):
        visualize_spectrogram(spec, power=3)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # a machine without matplotlib
    assert visualize_spectrogram(spec) is None

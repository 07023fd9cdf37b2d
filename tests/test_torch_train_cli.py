"""The port's training CLI (``cli/train.py``) on the CPU at tiny widths,
for both families: a few steps, checkpoints at the intervals, the probe
and its best checkpoint, validation, resume, sample dumps (GAN) and the
probe-best ``best_inference.npz``, which must load in the JAX package's
``load_params_npz`` and serve there as in the port; the phase-mode CNN
trained and served from its checkpoint directory; the flags against the
JAX CLI's; the refusals; and the on-device gap draws.

The CLI draws its gaps from a ``torch.Generator`` and JAX's from
``jax.random``, so the runs themselves are held to themselves (the
checkpoint equal to the final state bit for bit, resume's numbering and
Adam step counts), and the export to JAX: the same npz served by both
packages within ``2e-5`` of the waveform (``tests/test_torch_inference.py``'s
bound for the CNN+BiLSTM, restored clips of peak ~1) and ``1e-4`` for the
GAN (its generator's ``1e-5`` on the Tanh output of
``tests/test_torch_pconv_unet.py``, through ``expm1`` of a log1p
magnitude and the iSTFT).  Tiny configs as JSON (``--config``): 0.5 s clips,
BiLSTM hidden 8, a 3-stage generator, no VGG.  The GAN trains in f32 here:
on the CPU, oneDNN's bf16 convolution backward can leave its outputs
unwritten, so a bf16 step reads whatever memory held (NaN, under the
allocation pattern of a sample dump; ROADMAP Queue C 9); the CLI's bf16 GAN
runs on the card (``chip_smoke.py`` phase ``training_cli``).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.cli import train as jax_train
from ml_audio_inpainting_tpu.runtime import inference as jax_inference
from ml_audio_inpainting_tpu.train import cnn_trainer as jax_cnn
from ml_audio_inpainting_tpu.train import gan_trainer as jax_gan
from ml_audio_inpainting_tpu.train.checkpoints import load_params_npz as jax_load_npz
from ml_audio_inpainting_tpu.utils.config import load_config as jax_load_config
from ml_audio_inpainting_torch.cli import inpaint, train
from ml_audio_inpainting_torch.data.audio_io import read_audio, save_audio
from ml_audio_inpainting_torch.data.multigap import multi_gap_layout
from ml_audio_inpainting_torch.runtime.serve import (
    make_cnn_phase_runner,
    make_cnn_runner,
    make_gan_runner,
)
from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from ml_audio_inpainting_torch.train.checkpoints import CheckpointManager, state_tree
from ml_audio_inpainting_torch.utils.config import Config, load_config
from ml_audio_inpainting_torch.weights import load_params_npz
from test_torch_checkpoints import _assert_trees_equal

LOGGING = {"metric_interval": 1, "checkpoint_interval": 1, "log_interval": 1,
           "sample_interval": 2}
CNN_CFG = {"data": {"max_len_s": 0.5, "gap_len_s": 0.05, "gaps_per_audio": 2},
           "model": {"num_lstm_layers": 1, "lstm_hidden_dim": 8, "enc_filters": [2, 4],
                     "dec_filters": [2, 4]},
           "training": {"batch_size": 2, "starter_learning_rate": 1e-3}, "logging": LOGGING}
GAN_CFG = {"data": {"max_len_s": 0.5, "gap_len_s": 0.05,
                    "spectrogram": {"n_fft": 512, "hop_length": 128, "win_length": 512}},
           "model": {"generator": {"enc_layer_cfg": [[8, 7, 2], [16, 5, 2], [16, 3, 2]],
                                   "dec_layer_cfg": [[16, 3, 1], [8, 3, 1]],
                                   "final_interim_ch": 8},
                     "discriminator": {"layer_cfg": [[8, 2], [16, 1]]}},
           "training": {"batch_size": 2, "lambda_vgg_perceptual": 0.0,
                        "lambda_vgg_style": 0.0}, "logging": LOGGING}
COMMON = ["--synthetic", "4", "--corpus", "harmonic", "--device", "cpu", "--workers", "2"]


def _config(tmp_path, tree, name="cfg.json"):
    path = tmp_path / name
    path.write_text(json.dumps(tree))
    return str(path)


def _clips():
    return speech_like_batch(np.random.default_rng(8), 2, 0.5)


def test_train_cli_flags_are_the_jax_clis_and_device():
    ours = {a.dest for a in train.build_argparser()._actions}
    theirs = {a.dest for a in jax_train.build_argparser()._actions}
    assert ours == theirs | {"device"}
    assert train.build_argparser().parse_args(["--model", "gan"]).device == "cuda"


def test_cnn_cli_trains_probes_saves_resumes_and_exports(tmp_path):
    cfg_path = _config(tmp_path, CNN_CFG)
    res = train.main(["--model", "cnn_blstm", "--config", cfg_path, *COMMON, "--steps", "4",
                      "--probe-every", "2", "--probe-clips", "2", "--ema", "0.9",
                      "--valid-every", "2", "--valid-batches", "1",
                      "--base-dir", str(tmp_path / "a")])
    # 4 clips of B=2: 2 steps an epoch, a checkpoint every epoch.
    mgr = CheckpointManager(res.checkpoint_dir)
    assert res.step == 4 and mgr.all_steps() == [2, 4]
    _assert_trees_equal(mgr.load_tree(4), state_tree(res.state))
    assert [p[0] for p in res.probes] == [2, 4] and res.best_step in (2, 4)
    assert len(res.intervals) == 4 and res.feed == "device"
    assert (tmp_path / "a" / "logs" / f"{res.run_name}.log").is_file()

    # The export: the best step's EMA weights with its running statistics, in f16.
    best = CheckpointManager(res.checkpoint_dir / "best").load_tree(res.best_step)
    flat = load_params_npz(res.best_npz)
    np.testing.assert_array_equal(
        flat["params/lstm/l0_fwd_w_hh"],
        best["ema_params"]["lstm.l0_fwd_w_hh"].half().float().numpy())
    np.testing.assert_array_equal(flat["batch_stats/enc_bn0/mean"],
                                  best["model"]["enc_bn0.running_mean"].half().float().numpy())

    # Served by JAX's inference from JAX's loader, and by the port's runner.
    jcfg = jax_load_config(cfg_path)
    jax_fn = jax_inference.make_cnn_inpaint_fn(jcfg, jax_cnn.build_model(jcfg))
    clips = _clips()
    gs, gl = np.array([2000, 4000]), np.array([800, 800])
    want, _ = jax_fn(jax_load_npz(res.best_npz), jnp.asarray(clips), jnp.asarray(gs),
                     jnp.asarray(gl))
    got = make_cnn_runner(load_config(cfg_path), res.best_npz, device="cpu")(clips, gs, gl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)

    # Resume another run's latest step; numbering and Adam's step counts go on.
    res2 = train.main(["--model", "cnn_blstm", "--config", cfg_path, *COMMON, "--steps", "5",
                       "--ema", "0.9", "--resume-from", str(res.checkpoint_dir),
                       "--base-dir", str(tmp_path / "b")])
    assert res2.step == 5 and CheckpointManager(res2.checkpoint_dir).all_steps() == [5]
    adam = next(iter(res2.state.optimizer.state.values()))
    assert int(adam["step"]) == 5 and res2.state.step == 5
    with pytest.raises(SystemExit, match="no checkpoint"):
        train.main(["--model", "cnn_blstm", "--config", cfg_path, *COMMON,
                    "--resume-from", str(tmp_path / "nothing"), "--base-dir", str(tmp_path / "c")])


def test_gan_cli_trains_dumps_samples_saves_and_exports(tmp_path):
    cfg_path = _config(tmp_path, GAN_CFG)
    res = train.main(["--model", "gan", "--config", cfg_path, *COMMON, "--steps", "4",
                      "--probe-every", "2", "--probe-clips", "2", "--ema", "0.9",
                      "--feed", "stream", "--base-dir", str(tmp_path / "a")])
    assert set(res.state) == {"g", "d"} and res.feed == "stream"
    mgr = CheckpointManager(res.checkpoint_dir)
    assert mgr.all_steps() == [2, 4]
    _assert_trees_equal(mgr.load_tree(4), state_tree(res.state))
    assert [p.name for p in res.samples] == ["sample_step0000002.flac", "sample_step0000004.flac"]
    samples, rate, md5_ok = read_audio(res.samples[-1])
    assert rate == 16000 and md5_ok and samples.shape == (8000, 1)

    jcfg = jax_load_config(cfg_path)
    jax_fn = jax_inference.make_gan_inpaint_fn(jcfg, jax_gan.build_generator(jcfg),
                                               mode="enhanced")
    clips = _clips()
    gs, gl = np.array([2000, 4000]), np.array([800, 800])
    want, _ = jax_fn(jax_load_npz(res.best_npz), jnp.asarray(clips), jnp.asarray(gs),
                     jnp.asarray(gl))
    got = make_gan_runner(load_config(cfg_path), res.best_npz, device="cpu")(clips, gs, gl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_phase_mode_cli_trains_and_its_directory_serves(tmp_path):
    """``--phase-mode --phase-anchor``: the 2-channel model trains, and the
    ``inpaint`` CLI serves the run's checkpoint directory (its live weights,
    as JAX serves an orbax directory) with ``--model cnn_phase_anchored``."""
    cfg_path = _config(tmp_path, CNN_CFG)
    res = train.main(["--model", "cnn_blstm", "--config", cfg_path, *COMMON, "--steps", "2",
                      "--phase-mode", "--phase-anchor", "--base-dir", str(tmp_path / "a")])
    assert res.state.model.in_channels == 2 and res.best_npz is None
    clips = _clips()
    for i, clip in enumerate(clips):
        save_audio(clip, tmp_path / "in" / f"c{i}.flac")
    inpaint.main(["--model", "cnn_phase_anchored", "--config", cfg_path, "--checkpoint",
                  str(res.checkpoint_dir), "--input", str(tmp_path / "in"), "--output",
                  str(tmp_path / "out"), "--gap-start", "0.2", "--device", "cpu"])
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "c0_cnn_phase_anchored_inpainted.flac", "c1_cnn_phase_anchored_inpainted.flac"]
    cfg = load_config(cfg_path)
    cfg.model.cnn_blstm.in_channels = 2
    runner = make_cnn_phase_runner(cfg, res.checkpoint_dir, device="cpu", anchored=True)
    for name, want in res.state.model.state_dict().items():
        assert torch.equal(runner.model.state_dict()[name], want), name


@pytest.mark.parametrize("extra,match", [
    (["--model", "gan", "--model-parallel", "2"], "ROADMAP Queue A item 8"),
    (["--model", "cnn_blstm", "--remat"], "gan only"),
    (["--model", "gan", "--phase-mode"], "cnn_blstm only"),
    (["--model", "cnn_blstm", "--phase-anchor"], "requires --phase-mode"),
    (["--model", "cnn_blstm", "--phase-mode", "--train-n-gaps", "2"], "single-gap"),
])
def test_train_cli_refusals(tmp_path, extra, match):
    with pytest.raises(SystemExit, match=match):
        train.main([*extra, "--base-dir", str(tmp_path), "--device", "cpu"])
    assert not any(tmp_path.iterdir())  # refused before any run directory


def test_gap_draws_and_feed_choice():
    cfg = Config.from_dict({"data": {"max_len_s": 1.0, "gap_len_s": 0.2, "gaps_per_audio": 3}})
    draws = train.GapDraws(cfg, "cpu", seed=5)
    (starts,) = draws.cnn(4)
    assert starts.shape == (4, 3) and starts.dtype == torch.int64
    assert 0 <= starts.min() and starts.max() <= 16000 - 3200 and len(set(starts.tolist()[0])) > 1
    assert draws.gan(4)[0].shape == (4,)
    cfg.data.train_n_gaps = 3
    starts, lengths = train.GapDraws(cfg, "cpu", seed=5).cnn(2)
    gen = torch.Generator().manual_seed(5)
    u_len = torch.rand((2, 3, 3), generator=gen)
    u_pos = torch.rand((2, 3, 3), generator=gen)
    want = multi_gap_layout(u_len, u_pos, 16000, max_gap_ms=200.0)
    assert torch.equal(starts, want[0].long()) and torch.equal(lengths, want[1].long())
    assert train.GapDraws(cfg, "cpu", seed=5).gan(2)[0].shape == (2, 3)
    assert train.feed_choice("gan", "bf16", 32, 2**20, "cpu")[0] == "device"
    assert train.feed_choice("gan", "bf16", 32, 3 * 2**30, "cpu")[0] == "stream"

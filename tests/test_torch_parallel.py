"""Multi-device training and serving in the port (``ml_audio_inpainting_torch/
parallel/``) on gloo ranks on the CPU: the sharded steps of both families
and sharded serving against the port's one-rank step, and against JAX's
sharded step on JAX's virtual CPU devices (``tests/conftest.py``), on
JAX's draws and from the same weights (``weights.py``).  JAX runs in this
process; the ranks (``tests/torch_parallel_ranks.py``) import torch and
the port only.

One group of 4 ranks runs every case, each on its own mesh over the same
4 ranks: the CNN+BiLSTM on 4 x 1 (data parallel), 2 x 2 and 1 x 4 (data x
model: at hidden 16 with a 256-point STFT, layer 0's ``w_ih`` has 129 x 8
= 1032 rows and the ``projection`` 129 x 8 = 1032 outputs, both split over
``model``), each in f32 and bf16; the GAN on 4 x 1 in f32 and bf16; GAN
serving on 4 x 1; the training CLI with ``--model-parallel 2`` (a 2 x 2
mesh: ``gcd(batch 2, 4 // 2)`` data rows), its save, restore and resume,
and a run at B=1 that leaves 3 ranks idle; and the dry run's rank program
(``parallel/dryrun.py``), whose check runs here.  Weights are JAX's init redrawn (a live BiLSTM, as
``tests/test_torch_cnn_train.py`` draws them).  The GAN is the JAX dry
run's tiny configuration (``__graft_entry__.py:17-30``).

Bounds, the one-rank port against its sharded step (reduction order over
ranks in BatchNorm's moments, the losses and the gradient sum; and the f32
partial sums of the tensor-parallel products):

* loss rtol 1e-5 (f32), 5e-3 (bf16) (``tests/test_parallel.py``);
* parameters after one Adam step atol 2.1e-4 at lr 1e-4 (CNN), 4.1e-4
  at lr 2e-4 (GAN): one step's worth (``tests/test_parallel.py``);
* BatchNorm running statistics rtol 1e-4 atol 1e-5 (f32), rtol 2e-2 atol
  1e-3 (bf16) (``tests/test_parallel.py``); D's spectral-norm ``u`` and
  ``sigma`` 1e-5;
* every gradient (summed over ``data``, a split one gathered over
  ``model``; compared because one Adam step moves a parameter by the sign
  of its gradient only, and would not see a gradient counted twice):
  within 2e-4 of its tensor's largest entry in f32 (measured <= 8.9e-5),
  the conv biases in front of BatchNorm (exact gradient 0: noise) within
  1e-5 of the largest gradient of all; in bf16 within 5e-2 of the
  tensor's largest entry (measured <= 9.5e-3) and the noise within 1e-3;
  the GAN's in bf16 within 0.1 of the tensor's L2 norm (the bf16 GAN
  bound of ``tests/test_torch_gan_train.py``);
* serving 2e-6 (``tests/test_parallel.py``);
* the CLI, one rank against 4 over 2 x 2 (the same batches: every rank
  draws the global batch's gaps from the seeded generator), from a live
  BiLSTM (a step-0 checkpoint of redrawn weights, ``--resume-from``): the
  losses rtol 1e-5, the parameters 2.1e-4 a step, running statistics
  rtol 1e-4 atol 1e-5; its save, the restore of it on a 2 x 2 mesh and
  the in-memory state of the run that saved it, bit for bit.

Against JAX's sharded step, the one-device port-vs-JAX bounds of
``tests/test_torch_cnn_train.py`` (loss rtol 1e-5; parameters 1e-6 + 2e-2
lr, the noisy biases 2 lr; running statistics rtol 1e-5 + 4e-2 lr) and
``tests/test_torch_gan_train.py`` (losses rtol 1e-5; parameters within 2
lr, 99.9 % within 0.05 lr; state 1e-5; in bf16 losses rtol 5e-3, D's
spectral-norm state 2e-2, parameters 4.1e-4).  JAX's sharded CNN step is
held in f32 only: its bf16 ``lax.scan`` carries bf16 state and is not the
reference (``tests/test_torch_bf16_train.py``), and its Pallas form under
a mesh would run interpret mode over every rank's scan.
"""

import json
import os
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from __graft_entry__ import _tiny_cnn_cfg, _tiny_gan_cfg
from test_torch_cnn_train import NOISE_GRAD, _assert_variables_close, _redraw, _starts_of_key, flatten
from test_torch_gan_features import gaps_of_key
from test_torch_checkpoints import _assert_trees_equal
from test_torch_gan_train import _check_params, jax_states

from ml_audio_inpainting_tpu.parallel import mesh as jax_mesh
from ml_audio_inpainting_tpu.parallel import sharding as jax_sharding
from ml_audio_inpainting_tpu.train import cnn_trainer as jax_cnn
from ml_audio_inpainting_tpu.train import gan_trainer as jax_gan
from ml_audio_inpainting_tpu.utils.config import Config as JaxConfig
from ml_audio_inpainting_torch.cli import train
from ml_audio_inpainting_torch.models.build import build_model
from ml_audio_inpainting_torch.parallel.dryrun import report, tiny_cnn_config, tiny_gan_config
from ml_audio_inpainting_torch.parallel.launch import spawn
from ml_audio_inpainting_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from ml_audio_inpainting_torch.parallel.sharding import _TP_MIN_DIM, state_shardings
from ml_audio_inpainting_torch.runtime.inference import make_gan_inpaint_fn
from ml_audio_inpainting_torch.train.checkpoints import (
    CheckpointManager,
    load_state_tree,
    state_tree,
)
from ml_audio_inpainting_torch.train.cnn_trainer import create_cnn_state, make_cnn_train_step
from ml_audio_inpainting_torch.train.gan_trainer import create_gan_states, make_gan_train_step
from ml_audio_inpainting_torch.train.recipe import live_bilstm
from ml_audio_inpainting_torch.utils.config import Config, load_config
from ml_audio_inpainting_torch.weights import (
    cnn_blstm_flat_variables,
    discriminator_flat_variables,
    pconv_unet_flat_variables,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture)

SR, N = 16000, 8000
CLIPS, VARIANTS = 4, 2
CNN_LR = 1e-4
CNN_CFG = {
    "data": {"max_len_s": 0.5, "gap_len_s": 0.05, "gaps_per_audio": VARIANTS,
             "spectrogram": {"n_fft": 256, "hop_length": 64, "win_length": 256}},
    "model": {"num_lstm_layers": 2, "lstm_hidden_dim": 16, "enc_filters": [4, 8],
              "dec_filters": [8, 8]},
    "training": {"batch_size": CLIPS, "starter_learning_rate": CNN_LR},
}
SPLIT = ["lstm.l0_bwd_w_ih", "lstm.l0_fwd_w_ih", "projection.weight"]
CNN_MESHES = ((4, 1), (2, 2), (1, 4))
LOSS_RTOL = {"f32": 1e-5, "bf16": 5e-3}
BN_TOL = {"f32": (1e-4, 1e-5), "bf16": (2e-2, 1e-3)}
GRAD_OF_MAX = {"f32": 2e-4, "bf16": 5e-2}
NOISE_OF_MAX = {"f32": 1e-5, "bf16": 1e-3}
GAN_BF16_GRAD_L2 = 0.1
SN_ATOL = 1e-5
GAN_FLIP = 4.1e-4  # one Adam step's sign flip at the GAN's lr 2e-4 (tests/test_parallel.py)
SERVE_ATOL = 2e-6
CLI_CFG = {**{k: v for k, v in CNN_CFG.items() if k != "model"},
           "model": {**CNN_CFG["model"], "num_lstm_layers": 1},
           "training": {"batch_size": 2, "starter_learning_rate": CNN_LR},
           "logging": {"metric_interval": 1, "checkpoint_interval": 100}}
CLI_COMMON = ["--model", "cnn_blstm", "--synthetic", "4", "--corpus", "harmonic", "--workers",
              "1", "--probe-every", "1", "--probe-clips", "2"]


def _audio(seed=0, clips=CLIPS):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / SR
    return np.stack([np.sin(2 * np.pi * rng.uniform(100, 300) * t)
                     * (0.5 + 0.5 * np.sin(2 * np.pi * t)) + 0.05 * rng.standard_normal(N)
                     for _ in range(clips)]).astype(np.float32)


def _one_rank_cnn(cfg, flat, batch, dtype):
    state = create_cnn_state(cfg, device="cpu", params=flat)
    state, m = make_cnn_train_step(cfg, compute_dtype=ranks.DTYPES[dtype])(
        state, *(torch.as_tensor(x) for x in batch))
    return {"loss": m["loss"].item(), "variables": cnn_blstm_flat_variables(state.model.state_dict()),
            "grads": cnn_blstm_flat_variables({n: p.grad for n, p in state.model.named_parameters()})}


def _one_rank_gan(cfg, g_flat, d_flat, batch, dtype):
    g, d = create_gan_states(cfg, device="cpu", params=g_flat, d_params=d_flat)
    g, d, m = make_gan_train_step(cfg, compute_dtype=ranks.DTYPES[dtype])(
        g, d, *(torch.as_tensor(x) for x in batch))
    return {"metrics": {k: v.item() for k, v in m.items()},
            "g_variables": pconv_unet_flat_variables(g.model.state_dict()),
            "d_variables": discriminator_flat_variables(d.model.state_dict()),
            "g_grads": pconv_unet_flat_variables({n: p.grad for n, p in g.model.named_parameters()}),
            "d_grads": discriminator_flat_variables({n: p.grad for n, p in d.model.named_parameters()})}


def _cli_runs(tmp):
    """The CLI's config, a step-0 checkpoint of it with a live BiLSTM, and
    the argv of the 4 ranks' runs and of the one-rank runs."""
    config = tmp / "cfg.json"
    config.write_text(json.dumps(CLI_CFG))
    fresh = create_cnn_state(load_config(str(config)), device="cpu", seed=0).model.state_dict()
    flat = live_bilstm(cnn_blstm_flat_variables(fresh), seed=3)
    CheckpointManager(tmp / "init").save(0, create_cnn_state(load_config(str(config)), "cpu",
                                                             params=flat))
    base = [*CLI_COMMON, "--config", str(config)]
    live = [*base, "--resume-from", str(tmp / "init")]
    ranks_runs = [
        [*live, "--steps", "2", "--model-parallel", "2", "--base-dir", str(tmp / "a")],
        [*live, "--steps", "1", "--batch-size", "1", "--base-dir", str(tmp / "idle")],
        [*base, "--steps", "3", "--model-parallel", "2", "--base-dir", str(tmp / "b"),
         "--resume-from", ranks.RUN_DIR + str(tmp / "a")],
    ]
    one = {"d": [*live, "--steps", "2", "--base-dir", str(tmp / "d"), "--device", "cpu"],
           "c": [*base, "--steps", "3", "--base-dir", str(tmp / "c"), "--device", "cpu"]}
    return str(config), ranks_runs, one


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 4-rank group's results (it runs while JAX and the one-rank port
    run here), JAX's sharded steps, and the one-rank references."""
    tmp = tmp_path_factory.mktemp("cli")
    config, cli_runs, one_cli = _cli_runs(tmp)
    jcfg = JaxConfig.from_dict(CNN_CFG)
    cfg = Config.from_dict(CNN_CFG)
    jstate = jax_cnn.create_cnn_state(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = _redraw(jstate.params, rng)
    jstate = jstate.replace(params=params, batch_stats=_redraw(jstate.batch_stats, rng),
                            opt_state=jstate.tx.init(params))
    cnn_flat = flatten({"params": jstate.params, "batch_stats": jstate.batch_stats})
    audio = _audio()
    cnn_key = jax.random.PRNGKey(7)
    cnn_batch = (audio, _starts_of_key(cnn_key, CLIPS, VARIANTS, N, 0.05).numpy())

    gjcfg = _tiny_gan_cfg()
    gcfg = tiny_gan_config()
    g0, d0 = jax_states(gjcfg)
    g_flat = flatten({"params": g0.params, "batch_stats": g0.batch_stats})
    d_flat = flatten({"params": d0.params, "batch_stats": d0.batch_stats})
    gan_key = jax.random.PRNGKey(11)
    gan_batch = (audio, gaps_of_key(gan_key, 1, clips=CLIPS, n=N, gap_s=0.05)[0].numpy())
    serve_batch = (audio, np.linspace(1000, 6000, CLIPS).astype(np.int64),
                   np.full(CLIPS, 800, np.int64))

    cases = [(f"cnn {shape} {dt}", shape, "cnn_step",
              {"cfg": CNN_CFG, "flat": cnn_flat, "batch": cnn_batch, "dtype": dt})
             for shape in CNN_MESHES for dt in ("f32", "bf16")]
    cases += [(f"gan {dt}", (4, 1), "gan_step",
               {"cfg": gcfg.to_dict(), "g_flat": g_flat, "d_flat": d_flat, "batch": gan_batch,
                "dtype": dt}) for dt in ("f32", "bf16")]
    cases.append(("serve", (4, 1), "serve", {"cfg": gcfg.to_dict(), "g_flat": g_flat,
                                             "batch": serve_batch}))
    cases.append(("cli", None, "train_cli", {"runs": cli_runs, "config": config}))
    cases.append(("dryrun", None, "dryrun", {"n": 4}))
    out = {}
    group = threading.Thread(target=lambda: out.setdefault(
        "ranks", spawn(ranks.battery, 4, "cpu", cases, timeout_s=300)))
    group.start()
    try:
        devices = jax.devices()[:4]
        mesh = jax_mesh.make_mesh(2, 2, devices=devices)
        step = jax_sharding.make_sharded_step(jax_cnn.make_cnn_train_step(jcfg), jstate, mesh)
        js, jm = step(jax_sharding.place_state(jstate, mesh),
                      jax_mesh.shard_batch(audio, mesh), cnn_key)
        out["jax_cnn"] = (float(jm["loss"]), flatten({"params": js.params,
                                                      "batch_stats": js.batch_stats}))
        dp = jax_mesh.make_mesh(4, 1, devices=devices)
        g_sh = jax_sharding.state_shardings(g0, dp)
        d_sh = jax_sharding.state_shardings(d0, dp)
        for dt, compute_dtype in (("f32", None), ("bf16", jnp.bfloat16)):
            gan = jax.jit(jax_gan.make_gan_train_step(gjcfg, compute_dtype=compute_dtype),
                          in_shardings=(g_sh, d_sh, jax_mesh.batch_sharding(dp),
                                        jax_mesh.replicated(dp)),
                          out_shardings=(g_sh, d_sh, jax_mesh.replicated(dp)))
            g1, d1, gm = gan(jax.device_put(g0, g_sh), jax.device_put(d0, d_sh),
                             jax_mesh.shard_batch(audio, dp), gan_key)
            out[f"jax_gan {dt}"] = ({k: float(v) for k, v in gm.items()},
                                    flatten({"params": g1.params, "batch_stats": g1.batch_stats}),
                                    flatten({"params": d1.params, "batch_stats": d1.batch_stats}))
        out["one_cnn"] = {dt: _one_rank_cnn(cfg, cnn_flat, cnn_batch, dt) for dt in ("f32", "bf16")}
        out["one_gan"] = {dt: _one_rank_gan(gcfg, g_flat, d_flat, gan_batch, dt)
                          for dt in ("f32", "bf16")}
        gen, _ = create_gan_states(gcfg, device="cpu", params=g_flat)
        fn = make_gan_inpaint_fn(gcfg, gen.model, mode="enhanced")
        out["one_serve"] = [t.numpy() for t in fn(*(torch.as_tensor(x) for x in serve_batch))]
        out["cli_d"] = train.main(one_cli["d"])
    finally:
        group.join()
    assert "ranks" in out, "the rank group failed (its traceback is above)"
    out["cli_c"] = train.main([*one_cli["c"], "--resume-from", ranks._run_dir(str(tmp / "a"))])
    out.update(cfg=cfg, cnn_flat=cnn_flat, cli_config=config)
    return out


def _check_grads(label, got, want, dtype):
    top = max(np.abs(v).max() for v in want.values())
    for k, w in want.items():
        err = np.abs(got[k] - w).max()
        if k in NOISE_GRAD:
            assert err <= NOISE_OF_MAX[dtype] * top, f"{label} {k}: noise {err} vs {top}"
        else:
            bound = GRAD_OF_MAX[dtype] * np.abs(w).max()
            assert err <= bound, f"{label} {k}: {err} > {bound}"


def _check_bn(label, got, want, dtype):
    rtol, atol = BN_TOL[dtype]
    for k, w in want.items():
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=f"{label} {k}")


def test_tiny_configs_are_the_jax_dry_runs():
    for port, jax_cfg in ((tiny_gan_config(), _tiny_gan_cfg()), (tiny_cnn_config(), _tiny_cnn_cfg())):
        assert port.to_dict() == jax_cfg.to_dict()


def test_mesh_refusals_and_the_lone_process():
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == (0, 0)
    assert mesh.group("data") is None and mesh.group("model") is None
    for kwargs, match in (({"model_parallel": 2}, "does not divide 1 ranks"),
                          ({"model_parallel": 0}, "does not divide"),
                          ({"data_parallel": 2}, "mesh 2x1 != 1"),
                          ({"ranks": [0, 1]}, "not distinct ranks of a world of 1")):
        with pytest.raises(ValueError, match=match):
            make_mesh(**kwargs)
    x = np.arange(12.0).reshape(6, 2)
    np.testing.assert_array_equal(shard_batch(x, mesh).numpy(), x)


@pytest.mark.parametrize("cfg_of", [
    lambda: (JaxConfig(), Config()),
    lambda: (JaxConfig.from_dict(CNN_CFG), Config.from_dict(CNN_CFG)),
    lambda: (_tiny_cnn_cfg(), tiny_cnn_config()),
], ids=["full-width", "tp-test", "dry-run"])
@pytest.mark.parametrize("model_parallel", [2, 4])
def test_sharding_rule_marks_exactly_jaxs_tensors(cfg_of, model_parallel):
    """By JAX name (``weights.py``): at full width layer 0's ``w_ih`` (16448 x
    512, both directions) and the ``projection`` kernel (256 x 4112)."""
    jcfg, cfg = cfg_of()
    jmesh = jax_mesh.make_mesh(1, model_parallel, devices=jax.devices()[:model_parallel])
    rule = jax_sharding.param_sharding_rules(jmesh)
    shapes = jax.eval_shape(lambda k: jax_cnn.create_cnn_state(jcfg, k), jax.random.PRNGKey(0))
    specs = flatten(jax.tree_util.tree_map_with_path(
        lambda p, leaf: np.array(str(rule(p, leaf).spec)), {"params": shapes.params}))
    want = {k for k, spec in specs.items() if "model" in str(spec)}

    mesh = Mesh({"data": 1, "model": model_parallel}, tuple(range(model_parallel)), 0,
                torch.device("cpu"), {"data": None, "model": None})
    state = SimpleNamespace(model=build_model(cfg, "meta"))
    split = [n for n, s in state_shardings(state, mesh).items() if s.axis]
    got = set(cnn_blstm_flat_variables({n: torch.zeros(1, 1) for n in split}))
    assert got == want
    if jcfg.model.cnn_blstm.lstm_hidden_dim == 128:
        assert got == {"params/lstm/l0_fwd_w_ih", "params/lstm/l0_bwd_w_ih",
                       "params/projection/kernel"}
        assert _TP_MIN_DIM == 1024


@pytest.mark.parametrize("shape", CNN_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cnn_sharded_step_matches_one_rank(run, shape, dtype):
    label = f"cnn {shape} {dtype}"
    results = [r.value[label] for r in run["ranks"]]
    got, want = results[0], run["one_cnn"][dtype]
    assert got["mesh"] == {"data": shape[0], "model": shape[1]}
    assert got["sharded"] == ([] if shape[1] == 1 else SPLIT)  # a model-split parameter
    assert len({r["loss"] for r in results}) == 1
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL[dtype])
    _check_grads(label, got["grads"], want["grads"], dtype)
    for k, w in want["variables"].items():
        if k.startswith("params/"):
            np.testing.assert_allclose(got["variables"][k], w, atol=2.1 * CNN_LR, err_msg=k)
    _check_bn(label, got["variables"], want["variables"], dtype)
    for r in results[1:]:  # every rank holds the same (gathered) state
        for k, v in r["variables"].items():
            np.testing.assert_array_equal(v, got["variables"][k], err_msg=k)


def test_cnn_dp_x_tp_step_matches_jaxs_sharded_step(run):
    """Port 2 x 2 (f32) against JAX's ``make_sharded_step`` on a 2 x 2 mesh of
    virtual devices, the same weights and draws."""
    got = run["ranks"][0].value["cnn (2, 2) f32"]
    loss, want = run["jax_cnn"]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    _assert_variables_close(got["variables"], want, CNN_LR)


def test_sharded_state_gathers_into_the_one_device_layout(run):
    """``gather_state`` of the 2 x 2 state: the one-device tree, whose
    Adam moments of the split tensors are whole, loads into one rank."""
    tree = run["ranks"][1].value["cnn (2, 2) f32"]["tree"]
    state = create_cnn_state(run["cfg"], device="cpu", params=run["cnn_flat"])
    names = [n for n, _ in state.model.named_parameters()]
    for name in SPLIT:
        full = dict(state.model.named_parameters())[name].shape
        assert tree["model"][name].shape == full
        for k in ("exp_avg", "exp_avg_sq"):
            assert tree["optimizer"]["state"][names.index(name)][k].shape == full
    load_state_tree(state, tree)
    assert state.step == 1
    got = cnn_blstm_flat_variables(state.model.state_dict())
    for k, v in run["ranks"][0].value["cnn (2, 2) f32"]["variables"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gan_dp_step_matches_one_rank(run, dtype):
    """Losses, gradients, parameters, G's running statistics and D's
    spectral-norm state, 4 x 1 against one rank."""
    results = [r.value[f"gan {dtype}"] for r in run["ranks"]]
    got, want = results[0], run["one_gan"][dtype]
    for k in ("g_total", "d_total"):
        assert len({r["metrics"][k] for r in results}) == 1
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=LOSS_RTOL[dtype])
    for net in ("g", "d"):
        for k, w in want[f"{net}_grads"].items():
            g = got[f"{net}_grads"][k]
            if dtype == "f32":
                assert np.abs(g - w).max() <= GRAD_OF_MAX[dtype] * np.abs(w).max(), k
            else:
                assert np.linalg.norm(g - w) <= GAN_BF16_GRAD_L2 * np.linalg.norm(w), k
        for k, w in want[f"{net}_variables"].items():
            v = got[f"{net}_variables"][k]
            if k.startswith("params/"):
                np.testing.assert_allclose(v, w, atol=GAN_FLIP, err_msg=k)
            elif k.endswith(("/u", "/sigma")):
                np.testing.assert_allclose(v, w, rtol=0, atol=SN_ATOL, err_msg=k)
        _check_bn(f"gan {net}", got[f"{net}_variables"], want[f"{net}_variables"], dtype)
        for r in results[1:]:
            for k, v in r[f"{net}_variables"].items():
                np.testing.assert_array_equal(v, got[f"{net}_variables"][k], err_msg=k)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gan_dp_step_matches_jaxs_sharded_step(run, dtype):
    """In bf16 at the bf16 bounds of ``tests/test_torch_gan_train.py``:
    losses rtol 5e-3, D's ``u`` and ``sigma`` 2e-2, and every parameter
    within Adam's sign-flip bound of ``tests/test_parallel.py``, 4.1e-4 at
    lr 2e-4 (a flip moves an entry by 2 lr, plus its rounding)."""
    got = run["ranks"][0].value[f"gan {dtype}"]
    metrics, g_want, d_want = run[f"jax_gan {dtype}"]
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5 if dtype == "f32" else 5e-3,
                                   atol=0 if dtype == "f32" else 1e-6, err_msg=k)
    if dtype == "f32":
        _check_params(got["g_variables"], g_want, 1, "G")
        _check_params(got["d_variables"], d_want, 1, "D")
        return
    for variables, want in ((got["g_variables"], g_want), (got["d_variables"], d_want)):
        for k, w in want.items():
            if k.startswith("params/"):
                np.testing.assert_allclose(variables[k], w, rtol=0, atol=GAN_FLIP, err_msg=k)
            elif k.endswith(("/u", "/sigma")):
                np.testing.assert_allclose(variables[k], w, rtol=0, atol=2e-2, err_msg=k)


def test_sharded_serving_matches_one_rank(run):
    for r in run["ranks"]:
        got = r.value["serve"]
        for g, w in zip((got["restored"], got["generated"]), run["one_serve"]):
            np.testing.assert_allclose(g, w, rtol=0, atol=SERVE_ATOL)
        assert got["refusal"] == "batch 3 not divisible by data axis 4"


def test_the_ranks_ran_one_torch_thread_and_no_kernel(run):
    """``spawn`` returns each rank's value and launch counts in rank order;
    on the CPU a rank runs one torch thread, and the LSTM wrappers take the
    plain versions and count nothing.  A rank that raises fails the call."""
    assert [r.rank for r in run["ranks"]] == [0, 1, 2, 3]
    assert all(r.value["threads"] == 1 for r in run["ranks"])
    assert all(set(r.kernel_launches.values()) == {0} for r in run["ranks"])
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        spawn(ranks.fail_on_rank_1, 2, "cpu")


def _cli(run, i):
    """The CLI's ``i``-th run on each of the 4 ranks."""
    return [r.value["cli"][i] for r in run["ranks"]]


def _assert_cli_close(got, want, steps):
    g, w = cnn_blstm_flat_variables(got["model"]), cnn_blstm_flat_variables(want["model"])
    for k, v in w.items():
        if k.startswith("params/"):
            np.testing.assert_allclose(g[k], v, rtol=0, atol=2.1 * CNN_LR * steps, err_msg=k)
        else:
            np.testing.assert_allclose(g[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_cli_model_parallel_run_matches_one_rank(run):
    """``cli/train.py --model-parallel 2`` on 4 ranks (2 x 2) against one rank,
    2 steps; the first rank alone probes (on the gathered weights) and
    exports."""
    a, d = _cli(run, 0), run["cli_d"]
    assert a[0]["mesh"] == {"data": 2, "model": 2} and a[0]["sharded"] == SPLIT
    assert [x["step"] for x in a] == [2] * 4 and d.step == 2
    for (step, got), (_, want) in zip(a[0]["losses"], d.losses):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=step)
    _assert_cli_close(a[0]["tree"], state_tree(d.state), 2)
    for other in a[1:]:
        assert other["losses"] == a[0]["losses"]
        _assert_trees_equal(other["tree"], a[0]["tree"])
    assert [x["probes"] for x in a] == [2, 0, 0, 0]
    assert a[0]["best_npz"] is not None and all(x["best_npz"] is None for x in a[1:])
    assert os.path.isfile(a[0]["best_npz"])


def test_cli_save_is_the_gathered_state_and_restores_anywhere(run):
    """The save holds the whole (gathered) state in the one-device layout,
    bit for bit; it restores on a 2 x 2 mesh (sliced) and into one rank."""
    a = _cli(run, 0)
    saved = CheckpointManager(a[0]["run_dir"]).load_tree()
    _assert_trees_equal(saved, a[0]["tree"])
    for restored in _cli(run, 3):
        assert restored["sharded"] == SPLIT
        _assert_trees_equal(restored["restored"], saved)
    one = create_cnn_state(load_config(run["cli_config"]), device="cpu")
    load_state_tree(one, saved)
    assert one.step == 2
    assert one.model.lstm.l0_fwd_w_ih.shape == saved["model"]["lstm.l0_fwd_w_ih"].shape


def test_cli_resume_on_four_ranks_matches_resume_on_one(run):
    """``--resume-from`` the 4-rank save: one more step on 4 ranks and on one."""
    b, c = _cli(run, 2), run["cli_c"]
    assert b[0]["step"] == c.step == 3 and b[0]["tree"]["step"] == 3
    np.testing.assert_allclose(b[0]["losses"][-1][1]["loss"], c.losses[-1][1]["loss"], rtol=1e-5)
    _assert_cli_close(b[0]["tree"], state_tree(c.state), 1)
    for other in b[1:]:
        _assert_trees_equal(other["tree"], b[0]["tree"])


def test_cli_ranks_outside_the_gcd_mesh_leave_idle(run):
    """World 4 at B=1: the mesh is ``gcd(1, 4) = 1`` rank; ranks 1-3 leave."""
    idle = _cli(run, 1)
    assert not idle[0]["idle"] and idle[0]["mesh"] == {"data": 1, "model": 1}
    assert idle[0]["step"] == 1 and idle[0]["sharded"] == []
    assert idle[1:] == [{"idle": True, "mesh": {"data": 1, "model": 1}}] * 3


def test_dryrun_multichip_on_four_ranks(run, capsys):
    """``dryrun_multichip(4)``'s rank program ran on the 4 ranks
    (``parallel/dryrun.py::rank_program``); its check (``report``) here:
    CNN+BiLSTM over 2 x 2 with layer 0's ``w_ih`` split, the GAN over 4 x 1,
    finite losses that every rank agrees on."""
    out = report([r.value["dryrun"] for r in run["ranks"]], "cpu")
    assert out["mesh"] == {"data": 2, "model": 2}
    assert out["sharded"] == ["lstm.l0_bwd_w_ih", "lstm.l0_fwd_w_ih"]
    assert "dryrun_multichip OK on 4 ranks" in capsys.readouterr().out
    bad = [r.value["dryrun"] for r in run["ranks"][:2]]
    bad[1] = {**bad[1], "cnn_loss": bad[1]["cnn_loss"] + 1.0}
    with pytest.raises(AssertionError, match="ranks disagree on cnn_loss"):
        report(bad, "cpu")

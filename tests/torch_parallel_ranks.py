"""Rank programs of the port's multi-device tests
(``tests/test_torch_parallel*.py``), started by
``ml_audio_inpainting_torch/parallel/launch.py::spawn``.  The ranks import
torch and the port only (never JAX, which runs in the parent test
process): a spawned rank imports this module by name.

Every case takes the global batch as numpy arrays, places the state on the
mesh, runs one sharded step on this rank's rows and returns numpy results
in the one-device layout: the loss or losses, every gradient (a sharded
parameter's gathered over ``model``), the variables after the step (the
checkpoint tree of ``gather_state``) and the names the mesh split.
"""

from __future__ import annotations

import torch

from pathlib import Path

from ml_audio_inpainting_torch.cli import train
from ml_audio_inpainting_torch.parallel.collectives import all_gather_cat
from ml_audio_inpainting_torch.parallel.dryrun import rank_program
from ml_audio_inpainting_torch.parallel.mesh import make_mesh, shard_batch
from ml_audio_inpainting_torch.parallel.sharding import (
    gather_state,
    make_sharded_step,
    place_state,
)
from ml_audio_inpainting_torch.runtime.inference import (
    make_gan_inpaint_fn,
    make_sharded_serving_fn,
)
from ml_audio_inpainting_torch.train.cnn_trainer import create_cnn_state, make_cnn_train_step
from ml_audio_inpainting_torch.train.gan_trainer import create_gan_states, make_gan_train_step
from ml_audio_inpainting_torch.train.checkpoints import CheckpointManager
from ml_audio_inpainting_torch.utils.config import Config, load_config
from ml_audio_inpainting_torch.weights import (
    cnn_blstm_flat_variables,
    discriminator_flat_variables,
    pconv_unet_flat_variables,
)

DTYPES = {"f32": None, "bf16": torch.bfloat16}


def _grads(state, mesh):
    """Every parameter's gradient by torch name, a split one gathered."""
    out = {}
    for name, p in state.model.named_parameters():
        g = p.grad
        if name in state.shardings:
            g = all_gather_cat(g, mesh.group("model"), state.shardings[name].dim)
        out[name] = g
    return out


def cnn_step(device, mesh, cfg: dict, flat: dict, batch: tuple, dtype: str) -> dict:
    """One CNN+BiLSTM step of ``batch`` (audio, gap starts[, lengths])."""
    cfg = Config.from_dict(cfg)
    state = create_cnn_state(cfg, device=device, params=flat)
    step = make_sharded_step(make_cnn_train_step(cfg, compute_dtype=DTYPES[dtype]), state, mesh)
    place_state(state, mesh)
    state, m = step(state, *shard_batch(batch, mesh))
    tree = gather_state(state, mesh)
    return {"loss": m["loss"].item(), "grads": cnn_blstm_flat_variables(_grads(state, mesh)),
            "variables": cnn_blstm_flat_variables(tree["model"]),
            "sharded": sorted(state.shardings), "tree": tree}


def gan_step(device, mesh, cfg: dict, g_flat: dict, d_flat: dict, batch: tuple,
             dtype: str) -> dict:
    """One GAN step of ``batch`` (audio, gap starts[, lengths])."""
    cfg = Config.from_dict(cfg)
    g, d = create_gan_states(cfg, device=device, params=g_flat, d_params=d_flat)
    step = make_sharded_step(make_gan_train_step(cfg, compute_dtype=DTYPES[dtype]), (g, d),
                             mesh)
    place_state((g, d), mesh)
    g, d, m = step(g, d, *shard_batch(batch, mesh))
    return {"metrics": {k: v.item() for k, v in m.items()},
            "g_grads": pconv_unet_flat_variables(_grads(g, mesh)),
            "d_grads": discriminator_flat_variables(_grads(d, mesh)),
            "g_variables": pconv_unet_flat_variables(g.model.state_dict()),
            "d_variables": discriminator_flat_variables(d.model.state_dict())}


def serve(device, mesh, cfg: dict, g_flat: dict, batch: tuple) -> dict:
    """The GAN's ``enhanced`` inpaint function served over ``mesh``; and the
    refusal of a batch that does not divide by the data axis."""
    cfg = Config.from_dict(cfg)
    g, _ = create_gan_states(cfg, device=device, params=g_flat)
    fn = make_sharded_serving_fn(make_gan_inpaint_fn(cfg, g.model, mode="enhanced"), mesh)
    audio, gs, gl = (torch.as_tensor(x) for x in batch)
    restored, generated = fn(audio, gs, gl)
    try:
        fn(audio[:-1], gs[:-1], gl[:-1])
        refusal = None
    except ValueError as e:
        refusal = str(e)
    return {"restored": restored.cpu().numpy(), "generated": generated.cpu().numpy(),
            "refusal": refusal}


def battery(device, cases: list) -> dict:
    """Every case of ``cases`` (``(label, mesh shape, function name,
    kwargs)``) on this rank, the meshes made in order on every rank; a case
    with no shape makes its own."""
    meshes, out = {}, {"threads": torch.get_num_threads()}
    for label, shape, fn, kwargs in cases:
        if shape is None:
            out[label] = globals()[fn](device, **kwargs)
            continue
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device=device)
        out[label] = globals()[fn](device, meshes[shape], **kwargs)
        out[label]["mesh"] = dict(meshes[shape].shape)
    return out


def dryrun(device, n: int) -> dict:
    """The dry run's rank program (``parallel/dryrun.py``) on this rank."""
    return rank_program(device, n)


def fail_on_rank_1(device):
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 fails")
    return 0


RUN_DIR = "{run_dir}"


def _run_dir(base: str) -> str:
    """The one run directory a CLI run made under ``base``."""
    (run,) = (Path(base) / "checkpoints").iterdir()
    return str(run)


def train_cli(device, runs: list, config: str) -> list:
    """``cli/train.py``'s ``main`` on this rank for each argv of ``runs``
    (an argument ``"{run_dir}BASE"`` stands for the run directory that an
    earlier run made under ``BASE``); then the first run's latest
    checkpoint restored into a fresh state, placed on a ``data x 2`` mesh
    of every rank and gathered back."""
    out = []
    for argv in runs:
        argv = [_run_dir(a[len(RUN_DIR):]) if a.startswith(RUN_DIR) else a for a in argv]
        res = train.main([*argv, "--device", device.type])
        if res.state is None:
            out.append({"idle": True, "mesh": dict(res.mesh.shape)})
            continue
        out.append({"idle": False, "step": res.step, "tree": gather_state(res.state, res.mesh),
                    "losses": res.losses, "mesh": dict(res.mesh.shape),
                    "sharded": sorted(res.state.shardings), "probes": len(res.probes),
                    "best_npz": None if res.best_npz is None else str(res.best_npz),
                    "run_dir": str(res.checkpoint_dir)})
    mesh = make_mesh(-1, 2, device=device)
    state = create_cnn_state(load_config(config), device=device)
    CheckpointManager(_run_dir(runs[0][runs[0].index("--base-dir") + 1])).restore(state)
    place_state(state, mesh)
    out.append({"restored": gather_state(state, mesh), "sharded": sorted(state.shardings)})
    return out

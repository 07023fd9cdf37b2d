"""Data-parallel scaling of the train steps over ranks (port of
``ml_audio_inpainting_tpu/cli/scaling_bench.py``)::

    python -m ml_audio_inpainting_torch.cli.scaling_bench --devices 1 2 --steps 50 \\
        --output-json results/multichip_scaling.json [--chaos] [--device cpu]

For each ``--devices`` entry N, N ranks (``parallel/launch.py::spawn``)
train each model data-parallel at a FIXED global batch (strong scaling):
one warm-up step, then ``--steps`` timed steps (each loss read on the host,
as the JAX CLI reads it), from the same seeded weights, batch and gap
draws whatever N, so the loss trajectories differ only in the reduction
order over ranks; the drift is taken against the smallest N.  The JSON
keeps the JAX CLI's layout: ``condition``, ``models.{model}.{N}`` with
``steps_per_sec``, ``audio_seconds_per_sec``, ``final_loss`` and the
drift rows, and ``chaos_control``; it adds the backend, each rank's peak
device memory and ``kernel_launches.{N}``, each rank's LSTM kernel
launches by form.  ``--devices`` counts ranks: on a host
with a card a rank they run NCCL, and ranks that share a card (the
machine's one H100) run gloo; shared ranks measure the overhead of the
sharded program, not scaling.

``--chaos``: the chaos control, the one-rank step twice more from 1-ulp
perturbed parameters (once before step 0, and after every step), so the
multi-rank drift can be read against the drift ulp-scale noise alone
grows (``_perturb_one_leaf``).  ``--chaos-only`` runs the control alone
and merges it into an existing ``--output-json``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["build_argparser", "main"]

NOTE = ("strong scaling (fixed global batch). Ranks that share one card (or the CPU's cores) "
        "measure the overhead of the sharded program (collectives, host), not hardware "
        "scaling.")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DP scaling curve over ranks")
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8],
                   help="rank counts to run")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--global-batch", type=int, default=8,
                   help="fixed global batch (strong scaling); must divide by every --devices "
                        "entry")
    p.add_argument("--models", nargs="+", default=["gan", "cnn_blstm"],
                   choices=["gan", "cnn_blstm"])
    p.add_argument("--clip-seconds", type=float, default=1.0,
                   help="clip length (production is 5 s)")
    p.add_argument("--chaos", action="store_true",
                   help="also run the chaos control: the one-rank step from 1-ulp perturbed "
                        "parameters, once before step 0 and after every step, recording the "
                        "loss divergence; drift of the same size as the multi-rank drift is "
                        "reduction-order noise grown by training, not a sharding fault")
    p.add_argument("--chaos-only", action="store_true",
                   help="run only the chaos control and merge its rows into an existing "
                        "--output-json, keeping the measured scaling rows")
    p.add_argument("--output-json", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", choices=["cpu", "cuda"],
                   help="kind of device each rank runs on (default: cuda)")
    return p


def _config(model: str, clip_seconds: float):
    from ml_audio_inpainting_torch.utils.config import Config, SpectrogramConfig

    cfg = Config()
    if model == "gan":
        cfg.data.spectrogram = SpectrogramConfig(n_fft=512, hop_length=128, win_length=512)
        # as the JAX CLI: VGG terms off
        cfg.training.lambda_vgg_perceptual = 0.0
        cfg.training.lambda_vgg_style = 0.0
    cfg.data.max_len_s = clip_seconds
    return cfg


def _trainer(model: str, cfg, device, perturb: str = ""):
    """``(states, step(states, i, mesh) -> (states, loss))`` of one model at
    its fresh seeded weights (the CNN+BiLSTM's BiLSTM redrawn live: the
    initialiser's draw saturates it, and it would pass no gradient): step
    ``i`` runs on the global batch (seeded 0) with gaps seeded ``i``, this
    rank's rows of both."""
    from ml_audio_inpainting_torch.data.multigap import draw_gaps
    from ml_audio_inpainting_torch.parallel.mesh import shard_batch
    from ml_audio_inpainting_torch.parallel.sharding import make_sharded_step
    from ml_audio_inpainting_torch.train.cnn_trainer import (
        create_cnn_state,
        make_cnn_train_step,
    )
    from ml_audio_inpainting_torch.train.gan_trainer import (
        create_gan_states,
        make_gan_train_step,
    )
    from ml_audio_inpainting_torch.train.recipe import live_bilstm
    from ml_audio_inpainting_torch.weights import cnn_blstm_flat_variables

    d = cfg.data
    batch = cfg.training.batch_size
    audio = (np.random.default_rng(0).standard_normal((batch, d.max_samples))
             .astype(np.float32) * np.float32(0.1))
    shape = (batch, d.gaps_per_audio) if model == "cnn_blstm" else (batch,)

    def gaps(i: int):
        return draw_gaps(torch.Generator().manual_seed(i), shape, d.max_samples, d.gap_len_s,
                         d.sample_rate, d.train_n_gaps)

    if model == "cnn_blstm":
        fresh = create_cnn_state(cfg, device="cpu", seed=0).model.state_dict()
        states = (create_cnn_state(cfg, device=device,
                                   params=live_bilstm(cnn_blstm_flat_variables(fresh), seed=0)),)
        fn = make_cnn_train_step(cfg)
    else:
        states = create_gan_states(cfg, device=device)
        fn = make_gan_train_step(cfg)
    if perturb == "init":
        _perturb_one_leaf(states[0].model)

    def step(states, i, mesh):
        sharded = make_sharded_step(fn, states, mesh)
        *states, m = sharded(*states, *shard_batch((audio, *gaps(i)), mesh))
        if perturb == "every_step":
            _perturb_one_leaf(states[0].model)
        return tuple(states), m["loss" if model == "cnn_blstm" else "g_total"].item()

    return states, step


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank_curve(device, models: list, args: dict) -> dict:
    """One rank of an N-rank data-parallel run of each of ``models``: the
    warm-up step, then the timed steps; their losses, seconds a step and
    peak device memory."""
    from ml_audio_inpainting_torch.parallel.mesh import make_mesh
    from ml_audio_inpainting_torch.parallel.sharding import place_state

    mesh = make_mesh(device=device)
    out = {"backend": torch.distributed.get_backend()}
    for model in models:
        cfg = _config(model, args["clip_seconds"])
        cfg.training.batch_size = args["global_batch"]
        states, step = _trainer(model, cfg, device)
        place_state(states, mesh)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        states, _ = step(states, 0, mesh)  # warm-up
        _sync(device)
        t0 = time.perf_counter()
        losses = []
        for i in range(args["steps"]):
            states, loss = step(states, i, mesh)
            losses.append(loss)
        dt = (time.perf_counter() - t0) / args["steps"]
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        out[model] = {"losses": losses, "seconds_per_step": dt, "peak_memory_bytes": peak}
        del states
    return out


def _chaos(device, model: str, args: dict) -> dict:
    """The chaos control, in this process on one device: the loss
    trajectory unperturbed, and with the 1-ulp bump once before step 0 and
    after every step."""
    from ml_audio_inpainting_torch.parallel.mesh import make_mesh

    cfg = _config(model, args["clip_seconds"])
    cfg.training.batch_size = args["global_batch"]
    mesh = make_mesh(device=device)
    out = {}
    for variant in ("", "init", "every_step"):
        states, step = _trainer(model, cfg, device, perturb=variant)
        traj = []
        for i in range(args["steps"]):
            states, loss = step(states, i, mesh)
            traj.append(loss)
        out[variant or "base"] = traj
    return out


def _perturb_one_leaf(model: torch.nn.Module) -> None:
    """Move the first NONZERO f32 parameter's entries 1 ulp toward +inf, in
    place.  The first parameters are often zero biases, and
    ``nextafter(0, inf)`` is a subnormal that flush-to-zero can erase; a
    nonzero tensor's bump survives."""
    with torch.no_grad():
        for p in model.parameters():
            if p.dtype == torch.float32 and p.abs().max().item() > 1e-20:
                p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
                return
    raise ValueError("no nonzero float32 parameter to perturb")


def _condition(args, device_kind: str, platform: str) -> dict:
    return {"global_batch": args.global_batch, "steps": args.steps,
            "clip_seconds": args.clip_seconds, "platform": platform,
            "device_kind": device_kind, "note": NOTE}


def run(args) -> dict:
    """The payload: the scaling rows of every model (unless
    ``--chaos-only``) and, with ``--chaos``, the control."""
    from ml_audio_inpainting_torch.parallel.launch import spawn

    cuda = args.device == "cuda"
    device_kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    payload = {"condition": _condition(args, device_kind, "gpu" if cuda else "cpu"),
               "models": {}}
    shared = vars(args)
    curves = {}
    for n in ([] if args.chaos_only else sorted(args.devices)):
        out = spawn(_rank_curve, n, args.device, args.models, shared)
        curves[n] = [r.value for r in out]
        payload.setdefault("kernel_launches", {})[str(n)] = [r.kernel_launches for r in out]
    ref_n = min(args.devices)
    for model in args.models:
        per_n, ref = {}, None
        for n, out in curves.items():
            losses = np.asarray(out[0][model]["losses"])
            if any(r[model]["losses"] != out[0][model]["losses"] for r in out[1:]):
                raise AssertionError(f"{model} n={n}: ranks disagree on the loss")
            dt = max(r[model]["seconds_per_step"] for r in out)
            entry = {"steps_per_sec": 1.0 / dt,
                     "audio_seconds_per_sec": args.global_batch * args.clip_seconds / dt,
                     "final_loss": float(losses[-1]), "backend": out[0]["backend"],
                     "peak_memory_bytes_per_rank": [r[model]["peak_memory_bytes"] for r in out]}
            if ref is None:
                ref = losses
            else:
                drift = float(np.max(np.abs(losses - ref)))
                entry[f"max_abs_loss_drift_vs_{ref_n}dev"] = drift
                entry[f"max_rel_loss_drift_vs_{ref_n}dev"] = drift / (
                    float(np.max(np.abs(ref))) + 1e-12)
            per_n[str(n)] = entry
            print(f"{model} n={n}: {json.dumps(entry)}", flush=True)
        payload["models"][model] = per_n
        if args.chaos or args.chaos_only:
            traj = _chaos(torch.device(args.device), model, shared)
            base = np.asarray(traj["base"])
            entry = {"devices": 1, "steps": args.steps}
            for variant, label in (
                ("init", "1 ulp (torch.nextafter) on the first NONZERO parameter, once "
                         "before step 0"),
                ("every_step", "1 ulp on the first nonzero parameter after EVERY step "
                               "(per-step noise analogue)")):
                rel = np.abs(np.asarray(traj[variant]) - base) / (np.max(np.abs(base)) + 1e-12)
                entry[variant] = {"perturbation": label, "max_rel_loss_drift": float(np.max(rel)),
                                  "rel_drift_trajectory_every5": [float(x) for x in rel[::5]]}
                print(f"{model} chaos[{variant}]: {entry[variant]['max_rel_loss_drift']:.4g}",
                      flush=True)
            entry["note"] = ("one rank, one reduction order; the only difference is the stated "
                             "ulp-scale perturbation. Compare max_rel_loss_drift with the "
                             "multi-rank max_rel_loss_drift rows.")
            payload.setdefault("chaos_control", {})[model] = entry
    return payload


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    for n in args.devices:
        if args.global_batch % n:
            raise SystemExit(f"--global-batch {args.global_batch} % {n} != 0")
    payload = run(args)
    if args.output_json:
        out = Path(args.output_json)
        if args.chaos_only and out.exists():
            existing = json.loads(out.read_text())
            existing["chaos_control"] = payload.get("chaos_control", {})
            payload = existing
        out.write_text(json.dumps(payload, indent=2))
        print(f"wrote {args.output_json}", flush=True)
    return payload


if __name__ == "__main__":
    main()

"""Train the gap refiner head (port of
``ml_audio_inpainting_tpu/cli/train_refiner.py``).

The head rides on frozen deployable solvers (the AR fill and the committed
GAN under the extrapolated phase) and learns to raise gap SDR on the formant
corpus.  It is selected on a probe (held-out corpus clips under the
evaluation contract, 80 ms at 2.0 s, or real clips with ``--probe-dir``)
and exported as an npz in the JAX package's layout, which JAX's ``inpaint
--model refiner`` serves too::

    python -m ml_audio_inpainting_torch.cli.train_refiner --synthetic 2000 \\
        --corpus formant_v2 --steps 3000 --out refiner.npz [--device cpu]

The flags are the JAX CLI's and ``--device`` (``cuda`` unless the caller
asks for ``cpu``).  The clips of each step are picked on the host by
``numpy.random.default_rng(--seed)``, as in JAX; the gaps are drawn on the
device from a ``torch.Generator`` seeded ``--seed`` (JAX draws them from
``jax.random``), and a fresh head from a ``torch.Generator`` seeded
``--seed`` as well.  A step's batch is copied to the card through pinned
memory without a host sync; the logs every 50 steps and the probes read
floats, as JAX's do.  :func:`main` returns a :class:`TrainRefinerResult`.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["build_argparser", "main", "TrainRefinerResult"]

LOG_EVERY = 50


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the gap-refinement head")
    p.add_argument("--synthetic", type=int, default=2000,
                   help="training corpus size (held-out probe clips start at this index, so "
                        "they are never trained on)")
    p.add_argument("--corpus", choices=["formant", "formant_v2", "formant_v3"],
                   default="formant_v2")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--gan-checkpoint", type=str,
                   default="results/checkpoints/gan_formant_v2_r2.npz")
    p.add_argument("--gan-config", type=str, default=None,
                   help="GAN YAML (default: the GAN spectrogram profile)")
    p.add_argument("--gap-len-range", type=float, nargs=2, default=[0.04, 0.128])
    p.add_argument("--delta-penalty", type=float, default=0.0,
                   help="lambda on gap delta-to-reference energy: biases the head toward the "
                        "AR baseline (0 = raw gap-SDR objective)")
    p.add_argument("--probe-every", type=int, default=200)
    p.add_argument("--probe-clips", type=int, default=16)
    p.add_argument("--probe-dir", type=str, default=None,
                   help="directory of real probe clips for checkpoint selection, each probed "
                        "at --probe-positions")
    p.add_argument("--probe-positions", type=float, nargs="+", default=[1.0, 1.5, 2.0, 2.5, 3.0],
                   help="gap start times (s) per real probe clip")
    p.add_argument("--probe-patience", type=int, default=8,
                   help="stop after P probes without a new best (0 = off)")
    p.add_argument("--out", type=str, required=True, help="output npz path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


@dataclass
class TrainRefinerResult:
    """What a run did: the final state, each logged step's ``(step, loss,
    ar_baseline)``, each probe's ``(step, refined dB, AR dB)``, the best
    probe and its step (``-inf`` and -1 without probes), the export's path,
    and the wall seconds of each step (host time to its return: the device
    may still be working)."""

    state: object
    logs: List[Tuple[int, float, float]] = field(default_factory=list)
    probes: List[Tuple[int, float, float]] = field(default_factory=list)
    best: float = -np.inf
    best_step: int = -1
    out: Optional[Path] = None
    step_s: List[float] = field(default_factory=list)


def _to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    host = torch.from_numpy(batch)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)  # no host sync
    return host.to(device)


def main(argv=None, on_step=None) -> TrainRefinerResult:
    """Run the CLI.  ``on_step(i, state, metrics)``, if given, is called
    after each step (for instrumentation; the CLI itself passes none)."""
    from ml_audio_inpainting_torch.cli.inpaint import REPO
    from ml_audio_inpainting_torch.data.dataset import FormantSpeechDataset
    from ml_audio_inpainting_torch.runtime.serve import load_generator
    from ml_audio_inpainting_torch.train.checkpoints import export_params_npz
    from ml_audio_inpainting_torch.train.refiner_trainer import (
        create_refiner_state,
        draw_refiner_gaps,
        make_refiner_probe_fn,
        make_refiner_train_step,
    )
    from ml_audio_inpainting_torch.utils.config import gan_profile_config

    args = build_argparser().parse_args(argv)
    device = torch.device(args.device)
    cfg = gan_profile_config(args.gan_config)
    gan_ckpt = Path(args.gan_checkpoint)
    if not gan_ckpt.exists():
        gan_ckpt = REPO / args.gan_checkpoint  # the default is relative to the repository
    gan = load_generator(cfg, gan_ckpt, device)

    variant = args.corpus.split("_")[1] if "_" in args.corpus else "v1"
    ds = FormantSpeechDataset(n_items=args.synthetic + args.probe_clips,
                              sample_rate=cfg.data.sample_rate, max_len_s=cfg.data.max_len_s,
                              variant=variant)
    if args.probe_dir:
        from ml_audio_inpainting_torch.data.probe import load_real_probe_set

        pclips, pgs, n_files = load_real_probe_set(args.probe_dir, args.probe_positions,
                                                   cfg.data.sample_rate, cfg.data.max_len_s)
        probe_clips = torch.from_numpy(pclips).to(device)
        probe_gs = torch.from_numpy(pgs.astype(np.int64)).to(device)
        print(f"real probe: {n_files} clips x {len(args.probe_positions)} positions")
    else:
        probe_clips = torch.from_numpy(
            np.stack([ds[args.synthetic + i] for i in range(args.probe_clips)])).to(device)
        probe_gs = None

    state = create_refiner_state(torch.Generator().manual_seed(args.seed), lr=args.lr,
                                 channels=args.channels, device=device)
    step = make_refiner_train_step(cfg, gan, delta_penalty=args.delta_penalty)
    probe = make_refiner_probe_fn(cfg, gan)
    draws = torch.Generator(device=device).manual_seed(args.seed)
    n_samples = cfg.data.max_samples

    rng = np.random.default_rng(args.seed)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    res = TrainRefinerResult(state=state, out=out)
    # The fresh head is the AR fill: probe and save it first, so the export
    # never scores below AR on the probe.
    stale = 0
    if args.probe_every:
        sdr0, ar0 = probe(state.model, probe_clips, probe_gs)
        res.best, res.best_step = float(sdr0), 0
        res.probes.append((0, res.best, float(ar0)))
        export_params_npz(out, state.model)
        print(f"probe @ 0 (zero-init = AR): {res.best:+.3f} dB (AR {float(ar0):+.3f})", flush=True)
    t0 = time.time()
    for i in range(args.steps):
        ts = time.perf_counter()
        idx = rng.integers(0, args.synthetic, size=args.batch_size)
        audio = _to_device(np.stack([ds[int(j)] for j in idx]), device)
        gl, cands = draw_refiner_gaps(draws, cfg, args.batch_size, n_samples,
                                      tuple(args.gap_len_range))
        state, metrics = step(state, audio, gl, cands)
        res.step_s.append(time.perf_counter() - ts)
        if on_step is not None:
            on_step(i, state, metrics)
        if i % LOG_EVERY == 0:
            loss, base = float(metrics["loss"]), float(metrics["ar_baseline"])
            res.logs.append((i, loss, base))
            print(f"step {i}: loss {loss:+.4f} (ar baseline {base:+.4f}) "
                  f"[{i / max(time.time() - t0, 1e-9):.2f} it/s]", flush=True)
        if args.probe_every and (i + 1) % args.probe_every == 0:
            sdr, ar_sdr = (float(v) for v in probe(state.model, probe_clips, probe_gs))
            res.probes.append((i + 1, sdr, ar_sdr))
            marker = ""
            if sdr > res.best:
                res.best, res.best_step, stale = sdr, i + 1, 0
                export_params_npz(out, state.model)
                marker = "  <- new best (saved)"
            else:
                stale += 1
            print(f"probe @ {i + 1}: refined {sdr:+.3f} dB vs AR {ar_sdr:+.3f}{marker}", flush=True)
            if args.probe_patience and stale >= args.probe_patience:
                print(f"early stop: {stale} probes without improvement")
                break
    if args.probe_every:
        print(f"best probe gap-SDR {res.best:+.3f} dB @ step {res.best_step}; saved {out}")
    else:
        export_params_npz(out, state.model)  # no probe gate: the final step's weights
        print(f"no probe configured; saved final step {args.steps} to {out}")
    return res


if __name__ == "__main__":
    main()

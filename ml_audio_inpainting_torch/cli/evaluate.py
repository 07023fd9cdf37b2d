"""Evaluation CLI: the models' quality on a set of clips (port of
``ml_audio_inpainting_tpu/cli/evaluate.py``: the ``gan``, ``cnn_blstm`` and
phase-mode ``cnn_phase``/``cnn_phase_anchored`` models and the classical
solvers)::

    python -m ml_audio_inpainting_torch.cli.evaluate --models gan cnn_blstm \\
        --checkpoint results/checkpoints/gan_formant_v2_r2.npz \\
        --input results/formant_corpus_samples --output-json eval.json [--device cpu]

Each clip gets the evaluation gap (80 ms at 2.0 s by default; ``--n-gaps N``
draws N gaps of up to ``--gap-len`` a clip), is inpainted by each model, and
is scored on the device: gap SDR, SNR, log-spectral distance, fwSegSNR
(``train/metrics.py``), PSM (``train/auditory.py``) and ODG
(``train/peaq.py``).  The table goes to stdout and, with ``--output-json``,
the per-clip values (rounded to 3 decimals) under the JAX CLI's
``condition``/``results`` layout; ``--reconstructions`` writes the restored
clips as FLAC.

``--n-gaps > 1`` draws its layout from a ``torch.Generator`` seeded 7
(``data/multigap.py::random_multi_gap_layout``); the JAX CLI draws it from
``jax.random.PRNGKey(7)``, so the two place the gaps differently.  The
neural models restore every gap of a clip in one mask-driven pass, the
classical solvers one gap after another, left to right.  The ``phase`` of
the JSON's condition is written only when a neural model is evaluated (the
classical solvers have no phase regime).  The phase-mode models take one gap
a clip only (``--n-gaps > 1`` raises, as in JAX).  Unported models and
options raise ``SystemExit`` naming their ROADMAP item (``cli/inpaint.py``),
as do ``--golden`` and ``--adapt-steps``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["build_argparser", "main", "run", "load_clean", "gap_layout", "restore", "score"]

MULTI_GAP_SEED = 7
MIN_DIST_SAMPLES = 5000


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate inpainting models")
    p.add_argument("--models", nargs="+", required=True,
                   help="gan, cnn_blstm, cnn_phase, cnn_phase_anchored and the classical "
                        "solvers (janssen, arinpaint, segmentation, aspain, sspain, "
                        "sspain_omp, aspain_learned, sspain_learned); the refiner raises")
    p.add_argument("--gan-checkpoint", type=str,
                   default="results/checkpoints/gan_formant_v2_r2.npz",
                   help="GAN weights npz for the refiner model")
    p.add_argument("--gan-config", type=str, default=None,
                   help="GAN YAML for the refiner model (default: GAN profile)")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--checkpoint-longgap", type=str, default=None,
                   help="long-gap variant weights, used instead of --checkpoint when "
                        "--gap-len exceeds --longgap-threshold")
    p.add_argument("--longgap-threshold", type=float, default=None,
                   help="gap length (s) past which --checkpoint-longgap takes over "
                        "(default: 0.25 s)")
    p.add_argument("--input", type=str, required=True, help="directory of evaluation clips")
    p.add_argument("--output-json", type=str, default=None)
    p.add_argument("--reconstructions", type=str, default=None,
                   help="also write the inpainted clips here, as FLAC")
    p.add_argument("--gap-start", type=float, default=2.0)
    p.add_argument("--gap-len", type=float, default=0.08)
    p.add_argument("--ar-order", type=int, default=512)
    p.add_argument("--ar-context", type=int, default=4096)
    p.add_argument("--ar-blend", choices=["cos2", "linear", "sigmoid"], default="cos2")
    p.add_argument("--ar-blend-param", type=float, default=0.0)
    p.add_argument("--maxit", type=int, default=10)
    p.add_argument("--ar-preset", choices=["default", "tuned"], default="default",
                   help="'tuned' applies the measured per-gap-length configurations of "
                        "arinpaint and janssen (classical/presets.py), picked once from the "
                        "nominal --gap-len")
    p.add_argument("--ar-method", choices=["lpc", "arburg"], default="lpc")
    p.add_argument("--mode", choices=["parity", "enhanced"], default="parity")
    p.add_argument("--infer-dtype", choices=["f32", "bf16"], default="f32",
                   help="GAN generator precision (see cli/inpaint.py)")
    p.add_argument("--phase", choices=["oracle", "impaired", "extrapolate", "griffinlim"],
                   default="oracle", help="phase regime of the neural reconstruction")
    p.add_argument("--gl-iters", type=int, default=64)
    p.add_argument("--tta-shifts", type=int, default=1,
                   help="test-time sub-hop shift ensemble (1 = off)")
    p.add_argument("--adapt-steps", type=int, default=0,
                   help="per-clip test-time adaptation steps (not ported: 0 only)")
    p.add_argument("--adapt-lr", type=float, default=5e-5)
    p.add_argument("--adapt-batch", type=int, default=8)
    p.add_argument("--adapt-probe-every", type=int, default=25)
    p.add_argument("--adapt-n-gaps", type=int, default=4)
    p.add_argument("--adapt-seed", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--n-gaps", type=int, default=1,
                   help="N gaps of 10 ms to --gap-len a clip, at least 5000 samples apart, "
                        "all restored in one mask-driven pass")
    p.add_argument("--golden", type=str, default=None,
                   help="the reference's shipped reconstructions (not ported)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def load_clean(files: List[Path], cfg) -> np.ndarray:
    """The clips ``(n_files, S)`` f32 as the models take them (mono, the
    config's rate and length)."""
    from ml_audio_inpainting_torch.data.audio_io import load_audio

    sr = cfg.data.sample_rate
    return np.stack([load_audio(f, sample_rate=sr, max_len=cfg.data.max_len_s)[0] for f in files])


def gap_layout(args, n_clips: int, n_samples: int, sr: int, device) -> dict:
    """The evaluation gaps on ``device``: ``gs``, ``gl`` ``(B,)`` for one
    gap a clip, or with ``--n-gaps > 1`` the ``(B, K)`` ``starts`` and
    ``lengths`` of a layout seeded :data:`MULTI_GAP_SEED`; ``valid`` is
    the ``(B, S)`` mask (1 = signal)."""
    from ml_audio_inpainting_torch.data.multigap import gaps_mask, random_multi_gap_layout
    from ml_audio_inpainting_torch.ops.gaps import gap_mask

    if args.n_gaps > 1:
        gen = torch.Generator().manual_seed(MULTI_GAP_SEED)
        starts, lengths = random_multi_gap_layout(gen, (n_clips,), n_samples, args.n_gaps,
                                                  max_gap_ms=args.gap_len * 1000.0,
                                                  min_dist_samples=MIN_DIST_SAMPLES)
        starts, lengths = starts.to(device), lengths.to(device)
        return {"starts": starts, "lengths": lengths, "valid": gaps_mask(n_samples, starts, lengths)}
    gs = torch.full((n_clips,), int(args.gap_start * sr), dtype=torch.int64, device=device)
    gl = torch.full((n_clips,), int(args.gap_len * sr), dtype=torch.int64, device=device)
    return {"gs": gs, "gl": gl, "valid": gap_mask(n_samples, gs, gl)}


def score(clean: torch.Tensor, restored: torch.Tensor, gap: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every metric of a batch, ``(B,)`` each on the inputs' device;
    ``gap`` is 1 on the gap samples."""
    from ml_audio_inpainting_torch.train.auditory import psm_score
    from ml_audio_inpainting_torch.train.metrics import (
        fwseg_snr,
        gap_sdr,
        log_spectral_distance,
        snr,
    )
    from ml_audio_inpainting_torch.train.peaq import odg_score

    return {
        "gap_sdr_db": gap_sdr(clean, restored, gap),
        "snr_db": snr(clean, restored),
        "lsd_db": log_spectral_distance(clean, restored),
        "fwseg_snr_db": fwseg_snr(clean, restored),
        "psm": psm_score(clean, restored),
        "odg": odg_score(clean, restored),
    }


def restore(args, runner, clean: torch.Tensor, layout: dict) -> torch.Tensor:
    """One model's ``(B, S)`` restoration of ``clean`` on the device; with
    ``--n-gaps > 1`` every gap of a clip in one mask-driven pass (neural
    models) or one gap after another, left to right (classical solvers)."""
    from ml_audio_inpainting_torch.cli.inpaint import CLASSICAL

    if args.n_gaps <= 1:
        return runner(clean, layout["gs"], layout["gl"])
    if args.model in CLASSICAL:
        restored = clean * layout["valid"]
        for g in range(args.n_gaps):
            restored = runner(restored, layout["starts"][:, g], layout["lengths"][:, g])
        return restored
    from ml_audio_inpainting_torch.runtime.inference import (
        make_cnn_inpaint_mask_fn,
        make_gan_inpaint_mask_fn,
    )
    from ml_audio_inpainting_torch.utils.precision import full_f32_convolutions

    if args.model == "gan":
        mask_fn = make_gan_inpaint_mask_fn(runner.cfg, runner.model, mode=args.mode,
                                           phase=args.phase, gl_iters=args.gl_iters,
                                           compute_dtype=runner.compute_dtype)
    else:
        mask_fn = make_cnn_inpaint_mask_fn(runner.cfg, runner.model, phase=args.phase,
                                           gl_iters=args.gl_iters)
    with full_f32_convolutions():
        return mask_fn(clean, layout["valid"])[0]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(args, timings: Optional[Dict[str, float]] = None
        ) -> Tuple[List[Path], Dict[str, Dict[str, np.ndarray]]]:
    """Everything :func:`main` does before it prints: the files and each
    model's per-clip metrics, unrounded.  With ``timings`` (a dict), the
    wall seconds of reading the files (``read``), of each model's build and
    restoration (``model``), its metrics (``metrics``) and the written
    reconstructions (``write``) are added to it, the device synchronised at
    each boundary."""
    from ml_audio_inpainting_torch.cli.inpaint import (
        PHASE_MODELS,
        _build_runner,
        _collect,
        check_ported,
        route,
    )
    from ml_audio_inpainting_torch.data.audio_io import save_audio
    from ml_audio_inpainting_torch.utils.config import Config, load_config

    if args.golden:
        raise SystemExit("--golden is not ported: it needs the reference's shipped "
                         "reconstructions, which the repository does not hold")
    if args.adapt_steps > 0:
        raise SystemExit("--adapt-steps is not ported to ml_audio_inpainting_torch yet: "
                         "ROADMAP Queue A item 6 (refiner, adaptation and soups)")
    route(args)
    check_ported(args.models, args)
    if args.n_gaps > 1 and set(PHASE_MODELS) & set(args.models):
        raise SystemExit("--models cnn_phase[_anchored] supports single-gap eval only")
    cfg = load_config(args.config) if args.config else Config()
    sr = cfg.data.sample_rate
    clock = {} if timings is None else timings
    mark = [time.perf_counter()]

    def lap(key: str) -> None:
        if timings is not None:
            _sync(args.device)
            now = time.perf_counter()
            clock[key] = clock.get(key, 0.0) + now - mark[0]
            mark[0] = now

    files = _collect(Path(args.input))
    clean = torch.from_numpy(load_clean(files, cfg)).to(args.device)
    lap("read")
    layout = gap_layout(args, len(files), clean.shape[-1], sr, args.device)
    gap = 1.0 - layout["valid"]

    results = {}
    for model_name in args.models:
        m_args = argparse.Namespace(**vars(args))
        m_args.model = model_name
        runner = _build_runner(m_args, cfg)
        restored = restore(m_args, runner, clean, layout)
        lap("model")
        results[model_name] = {k: v.cpu().numpy() for k, v in score(clean, restored, gap).items()}
        lap("metrics")
        if args.reconstructions:
            outdir = Path(args.reconstructions)
            outdir.mkdir(parents=True, exist_ok=True)
            restored_np = restored.cpu().numpy()
            for j, f in enumerate(files):
                save_audio(restored_np[j], outdir / f"{f.stem}_{model_name}_inpainted.flac", sr)
            lap("write")
    return files, results


def main(argv=None) -> None:
    from ml_audio_inpainting_torch.train.peaq import ODG_MAPPING

    args = build_argparser().parse_args(argv)
    files, raw = run(args)
    results = {name: {k: [round(float(x), 3) for x in v] for k, v in r.items()}
               for name, r in raw.items()}

    header = (f"{'model':>14} | {'gap SDR':>8} | {'SNR':>7} | {'LSD':>6} | "
              f"{'fwsegSNR':>8} | {'PSM':>6} | {'ODG':>6}")
    print(header)
    print("-" * len(header))
    for name, r in results.items():
        print(f"{name:>14} | {np.mean(r['gap_sdr_db']):8.2f} | {np.mean(r['snr_db']):7.2f} | "
              f"{np.mean(r['lsd_db']):6.2f} | {np.mean(r['fwseg_snr_db']):8.2f} | "
              f"{np.mean(r['psm']):6.3f} | {np.mean(r['odg']):6.2f}")

    if args.output_json:
        condition = {
            "gap_start_s": args.gap_start,
            "gap_len_s": args.gap_len,
            "files": [f.name for f in files],
        }
        if any(m in ("gan", "cnn_blstm") for m in args.models):
            condition["phase"] = args.phase  # the classical solvers ignore it
        if args.n_gaps > 1:
            condition.update({
                "n_gaps": args.n_gaps,
                "gap_len_ms_range": [10.0, args.gap_len * 1000.0],
                "min_dist_samples": MIN_DIST_SAMPLES,
                "scheme": "IRMAS_gaps.m-style, solved left to right",
            })
        condition["odg_mapping"] = ODG_MAPPING
        Path(args.output_json).write_text(json.dumps({"condition": condition, "results": results},
                                                     indent=2))
        print(f"wrote {args.output_json}")


if __name__ == "__main__":
    main()

"""Inference CLI: inpaint FLAC/WAV files (port of
``ml_audio_inpainting_tpu/cli/inpaint.py``: every model of the JAX CLI)::

    python -m ml_audio_inpainting_torch.cli.inpaint --model gan \\
        --checkpoint results/checkpoints/gan_formant_v2_r2.npz --mode enhanced \\
        --phase extrapolate --input in.flac --output out.flac [--device cpu]
    python -m ml_audio_inpainting_torch.cli.inpaint --model arinpaint --ar-preset tuned \\
        --input dir/ --output outdir/ [--device cpu]
    python -m ml_audio_inpainting_torch.cli.inpaint --model refiner \\
        --checkpoint results/checkpoints/refiner_formant_v2_r3.npz --input dir/ \\
        --output outdir/ [--device cpu]

It takes the JAX CLI's flags and ``--device`` (``cuda`` unless the caller
asks for ``cpu``).  ``--checkpoint`` is an exported ``.npz``, a reference
``.pt``/``.pth`` (``models/port_torch.py``; not for the phase-mode model,
of which the reference shipped none), a directory of the port's training
checkpoints (``train/checkpoints.py``), or absent: fresh weights from the
port's initialiser seeded 0 (``runtime/serve.py``).  The phase-mode models
predict the complex spectrogram and take no ``--phase``.  The classical
solvers (``janssen``, ``arinpaint``, ``segmentation``, ``aspain``,
``sspain``, ``sspain_omp``, ``aspain_learned``, ``sspain_learned``) need no
weights.  The ``refiner`` (``runtime/serve.py::make_refiner_runner``) takes
its head as ``--checkpoint`` (required) and the GAN it rides on as
``--gan-checkpoint`` (the committed one by default, found from the
repository when the CLI runs elsewhere) with ``--gan-config``; it refuses
gaps over ``MAX_GAP`` samples, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path
from typing import List

import numpy as np
import torch

CLASSICAL = (
    "janssen", "arinpaint", "segmentation", "aspain", "sspain", "sspain_omp",
    "aspain_learned", "sspain_learned",
)
PHASE_MODELS = ("cnn_phase", "cnn_phase_anchored")
REPO = Path(__file__).resolve().parents[2]

__all__ = ["build_argparser", "main", "check_ported", "check_refiner_gap", "route", "apply_preset"]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Inpaint gapped audio")
    p.add_argument("--model", required=True,
                   choices=["gan", "cnn_blstm", "cnn_phase", "cnn_phase_anchored", "refiner",
                            *CLASSICAL])
    p.add_argument("--gan-checkpoint", type=str,
                   default="results/checkpoints/gan_formant_v2_r2.npz",
                   help="GAN weights npz for --model refiner")
    p.add_argument("--gan-config", type=str, default=None,
                   help="GAN YAML for --model refiner (default: GAN profile)")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="exported .npz weights, a reference .pt/.pth, or a training "
                        "checkpoint directory (fresh initial weights when omitted)")
    p.add_argument("--checkpoint-longgap", type=str, default=None,
                   help="long-gap variant weights, used instead of --checkpoint when "
                        "--gap-len exceeds --longgap-threshold")
    p.add_argument("--longgap-threshold", type=float, default=None,
                   help="gap length (s) past which --checkpoint-longgap takes over "
                        "(default: 0.25 s)")
    p.add_argument("--input", required=True, help="audio file or directory")
    p.add_argument("--output", required=True, help="output file or directory")
    p.add_argument("--gap-start", type=float, default=2.0, help="gap start (s)")
    p.add_argument("--gap-len", type=float, default=0.08, help="gap length (s)")
    p.add_argument("--mode", choices=["parity", "enhanced"], default="parity")
    p.add_argument("--phase", choices=["oracle", "impaired", "extrapolate", "griffinlim"],
                   default="oracle",
                   help="phase regime: the clean signal's phase (oracle), the gapped "
                        "signal's (impaired), its extrapolation over the gap "
                        "(extrapolate), or Griffin-Lim started from that (griffinlim)")
    p.add_argument("--infer-dtype", choices=["f32", "bf16"], default="f32",
                   help="GAN generator compute precision; the DSP stays f32")
    p.add_argument("--gl-iters", type=int, default=64,
                   help="Griffin-Lim iterations for --phase griffinlim")
    p.add_argument("--tta-shifts", type=int, default=1,
                   help="test-time ensemble of N sub-hop shifts, averaged inside the gap "
                        "(1 = off)")
    p.add_argument("--ar-order", type=int, default=512)
    p.add_argument("--ar-context", type=int, default=4096,
                   help="AR fit context samples per side (arinpaint.m's maxlen)")
    p.add_argument("--ar-blend", choices=["cos2", "linear", "sigmoid"], default="cos2",
                   help="arinpaint's forward/backward crossfade (cos2 = the reference's)")
    p.add_argument("--ar-blend-param", type=float, default=0.0,
                   help="floor c for linear, steepness k for sigmoid (0 = family default)")
    p.add_argument("--maxit", type=int, default=10)
    p.add_argument("--ar-preset", choices=["default", "tuned"], default="default",
                   help="'tuned' applies the measured per-gap-length configurations of "
                        "arinpaint and janssen (classical/presets.py) over the --ar-* flags")
    p.add_argument("--ar-method", choices=["lpc", "arburg"], default="lpc")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--basis", type=str, default=None,
                   help="npz file with a unitary 'basis' matrix for the learned-SPAIN "
                        "solvers (identity when omitted)")
    p.add_argument("--longform", action="store_true",
                   help="inpaint audio of any duration: overlapping model windows, "
                        "overlap-added (runtime/longform.py); the gap may be anywhere")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def _collect(inp: Path) -> List[Path]:
    """The audio files under a directory (sorted), or the one file given."""
    if inp.is_dir():
        return sorted(p for p in inp.rglob("*") if p.suffix.lower() in (".flac", ".wav", ".mp3"))
    return [inp]


def check_ported(models, args) -> None:
    """Raise ``SystemExit`` for a reference ``.pt`` given to the phase-mode
    model (the reference shipped none; the JAX CLI refuses it too)."""
    if any(m in PHASE_MODELS for m in models) and str(args.checkpoint).endswith((".pt", ".pth")):
        raise SystemExit("--model cnn_phase has no torch checkpoint port (the reference shipped "
                         "none); use an npz or a checkpoint directory")


def check_refiner_gap(args, sr: int, flag: str = "--model") -> None:
    """Raise ``SystemExit`` for a refiner gap longer than ``MAX_GAP``: past
    the head's window it would be zero-filled."""
    from ml_audio_inpainting_torch.train.refiner_trainer import MAX_GAP

    gap_len = int(args.gap_len * sr)
    if gap_len > MAX_GAP:
        raise SystemExit(
            f"{flag} refiner supports gaps up to {MAX_GAP} samples ({MAX_GAP / sr * 1000:.0f} "
            f"ms); got {gap_len}. Longer gaps would be silently zero-filled past the head's "
            "window -- use arinpaint/janssen or the longgap GAN instead.")


def route(args) -> None:
    """``--checkpoint-longgap``: serve a gap longer than the threshold with
    the long-gap weights."""
    if not args.checkpoint_longgap:
        return
    from ml_audio_inpainting_torch.runtime.inference import LONGGAP_THRESHOLD_S, route_checkpoint

    routed = route_checkpoint(
        args.gap_len, args.checkpoint, args.checkpoint_longgap,
        args.longgap_threshold if args.longgap_threshold is not None else LONGGAP_THRESHOLD_S,
    )
    if routed != args.checkpoint:
        print(f"gap {args.gap_len:.3f}s: routing to long-gap checkpoint {routed}")
    args.checkpoint = routed


def main(argv=None) -> None:
    from ml_audio_inpainting_torch.data.audio_io import load_audio, save_audio
    from ml_audio_inpainting_torch.utils.config import Config, gan_profile_config, load_config

    args = build_argparser().parse_args(argv)
    route(args)
    if args.model == "gan":
        cfg = gan_profile_config(args.config)
    else:
        cfg = load_config(args.config) if args.config else Config()
    if args.model == "refiner":
        check_refiner_gap(args, cfg.data.sample_rate)
    run_fn = _build_runner(args, cfg)

    sr = cfg.data.sample_rate
    files = _collect(Path(args.input))
    out_path = Path(args.output)
    out_is_dir = out_path.is_dir() or len(files) > 1
    if out_is_dir:
        out_path.mkdir(parents=True, exist_ok=True)
    gap_start = int(args.gap_start * sr)
    gap_len = int(args.gap_len * sr)
    n_samples = cfg.data.max_samples

    def dest_of(f: Path) -> Path:
        return out_path / f"{f.stem}_{args.model}_inpainted.flac" if out_is_dir else out_path

    if args.longform:
        if not hasattr(run_fn, "inpaint_fn"):
            raise SystemExit("--longform requires a neural model (gan/cnn_blstm)")
        from ml_audio_inpainting_torch.data.audio_io import read_audio, resample
        from ml_audio_inpainting_torch.runtime.longform import longform_inpaint

        for f in files:
            samples, rate, _ = read_audio(f)
            mono = samples.mean(axis=1) if samples.shape[1] > 1 else samples[:, 0]
            mono = resample(mono.astype(np.float32), rate, sr)
            restored = longform_inpaint(
                run_fn.inpaint_fn, torch.from_numpy(mono).to(args.device), gap_start, gap_len,
                window=n_samples, hop=n_samples // 2, batch_size=args.batch_size,
            )
            save_audio(restored, dest_of(f), sr)
            print(f"{f} ({len(mono)/sr:.1f}s) -> {dest_of(f)}")
        return

    for i in range(0, len(files), args.batch_size):
        chunk = files[i : i + args.batch_size]
        audio = np.stack([load_audio(f, sample_rate=sr, max_len=cfg.data.max_len_s)[0]
                          for f in chunk])
        restored = run_fn(audio, np.full(len(chunk), gap_start), np.full(len(chunk), gap_len))
        restored = restored.cpu().numpy()
        for j, f in enumerate(chunk):
            save_audio(restored[j], dest_of(f), sr)
            print(f"{f} -> {dest_of(f)}")


def _build_runner(args, cfg):
    """``runner(audio (B, S), gap_start (B,), gap_len (B,)) -> (B, S)``
    restored waveforms on ``args.device``, from numpy arrays or tensors.
    ``runner.inpaint_fn`` (the same with the auxiliary output, on tensors
    on the device), ``runner.model``, ``runner.cfg`` (the profile used) and
    ``runner.compute_dtype`` expose the pieces, and for the GAN
    ``runner.inpaint_factory(generator)``, ``inpaint_fn`` of another
    generator (the refiner's runner has ``head``, ``generator`` and
    ``cfg``).  Raises ``SystemExit`` where the JAX CLI refuses
    (:func:`check_ported`)."""
    from ml_audio_inpainting_torch.runtime.inference import make_gan_inpaint_fn, make_tta_shift_fn
    from ml_audio_inpainting_torch.runtime.serve import (
        make_cnn_phase_runner,
        make_cnn_runner,
        make_gan_runner,
    )
    from ml_audio_inpainting_torch.utils.config import gan_profile_config
    from ml_audio_inpainting_torch.utils.precision import full_f32_convolutions

    check_ported([args.model], args)
    if args.ar_preset == "tuned":
        apply_preset(args)
    if args.infer_dtype == "bf16" and args.model != "gan":
        raise SystemExit("--infer-dtype bf16 is supported for --model gan only")
    if args.model in CLASSICAL:
        return _build_classical_runner(args, cfg)
    if args.model == "refiner":
        return _build_refiner_runner(args)
    device = args.device
    compute_dtype = torch.bfloat16 if args.infer_dtype == "bf16" else None
    if args.model == "gan":
        if args.config is None:  # the GAN checkpoints are bound to the GAN profile
            cfg = gan_profile_config(None)
        base = make_gan_runner(cfg, args.checkpoint, device=device, mode=args.mode,
                               phase=args.phase, compute_dtype=compute_dtype,
                               gl_iters=args.gl_iters)
        model = base.generator
    elif args.model in PHASE_MODELS:
        # The complex 2-channel model predicts magnitude and phase: no --phase regime.
        cfg = copy.deepcopy(cfg)
        cfg.model.cnn_blstm.in_channels = 2
        base = make_cnn_phase_runner(cfg, args.checkpoint, device=device,
                                     anchored=args.model == "cnn_phase_anchored")
        model = base.model
    else:
        base = make_cnn_runner(cfg, args.checkpoint, device=device, phase=args.phase,
                               gl_iters=args.gl_iters)
        model = base.model

    def serving(fn):
        """``fn`` with the shift ensemble and full-f32 convolutions."""
        if args.tta_shifts > 1:
            fn = make_tta_shift_fn(fn, cfg.data.spectrogram.hop_length, args.tta_shifts)

        def inpaint_fn(audio, gap_start, gap_len):
            with full_f32_convolutions():  # bf16 convolutions are not affected
                return fn(audio, gap_start, gap_len)

        return inpaint_fn

    inpaint_fn = serving(base.inpaint_fn)

    def runner(audio, gap_start, gap_len) -> torch.Tensor:
        audio = torch.as_tensor(audio, dtype=torch.float32, device=device)
        gs = torch.as_tensor(gap_start, dtype=torch.int64, device=device)
        gl = torch.as_tensor(gap_len, dtype=torch.int64, device=device)
        return inpaint_fn(audio, gs, gl)[0]

    if args.model == "gan":
        # The same serving function of another generator (test-time adaptation).
        runner.inpaint_factory = lambda gen: serving(make_gan_inpaint_fn(
            cfg, gen, mode=args.mode, compute_dtype=compute_dtype, phase=args.phase,
            gl_iters=args.gl_iters))
    runner.inpaint_fn = inpaint_fn
    runner.model = model
    runner.cfg = cfg
    runner.compute_dtype = compute_dtype
    return runner


def _build_refiner_runner(args):
    """The refiner's runner (it has no ``inpaint_fn``: ``--longform``
    refuses it, as in JAX)."""
    from ml_audio_inpainting_torch.runtime.serve import make_refiner_runner
    from ml_audio_inpainting_torch.utils.config import gan_profile_config

    gan_ckpt = Path(args.gan_checkpoint)
    if not gan_ckpt.exists():
        gan_ckpt = REPO / args.gan_checkpoint  # the default is relative to the repository
    if not args.checkpoint:
        raise SystemExit("--model refiner requires --checkpoint (head npz)")
    return make_refiner_runner(gan_profile_config(args.gan_config), gan_ckpt, args.checkpoint,
                               device=args.device)


def apply_preset(args) -> None:
    """``--ar-preset tuned``: set the measured configuration of ``args.model``
    for ``args.gap_len`` on ``args`` (over any ``--ar-*``/``--maxit`` given:
    the preset is the measured choice) and say on stderr what it set.  Only
    ``arinpaint`` and ``janssen`` have presets."""
    from ml_audio_inpainting_torch.classical.presets import (
        tuned_arinpaint_preset,
        tuned_janssen_preset,
    )

    picker = {"arinpaint": tuned_arinpaint_preset, "janssen": tuned_janssen_preset}.get(args.model)
    if picker is None:
        return
    overrides = picker(float(args.gap_len))
    if overrides:
        print(f"--ar-preset tuned ({args.model}, gap {float(args.gap_len):.3f}s): applying "
              "measured overrides " + ", ".join(f"{k}={v}" for k, v in overrides.items()),
              file=sys.stderr)
    for k, v in overrides.items():
        setattr(args, k, v)


def _build_classical_runner(args, cfg):
    """The classical solver ``args.model`` over a batch, with the JAX CLI's
    settings: ``max_gap`` the next power of two of the gap, the SPAIN
    solvers at least 100 iterations (``sspain_omp`` 30), the learned ones on
    ``cfg``'s STFT with ``--basis`` or the identity.  ``runner(audio, gs,
    gl)`` zeroes each gap and solves on ``args.device``, in ``audio``'s
    floating dtype (f32 from numpy)."""
    from ml_audio_inpainting_torch.ops.gaps import gap_mask

    device = args.device
    max_gap = 1 << (int(args.gap_len * cfg.data.sample_rate) - 1).bit_length()
    m = args.model
    if m == "janssen":
        from ml_audio_inpainting_torch.classical.janssen import janssen_gapwise

        def solve(x, mask, gs, gl):
            return janssen_gapwise(x, mask, gs, gl, p=args.ar_order, maxit=args.maxit,
                                   method=args.ar_method, max_gap=max_gap,
                                   context=args.ar_context)
    elif m == "arinpaint":
        from ml_audio_inpainting_torch.classical.arinpaint import arinpaint

        def solve(x, mask, gs, gl):
            return arinpaint(x, mask, gs, gl, order=args.ar_order, max_gap=max_gap,
                             context=args.ar_context, method=args.ar_method,
                             blend=args.ar_blend, blend_param=args.ar_blend_param)
    elif m == "segmentation":
        from ml_audio_inpainting_torch.classical.ola import segmentation_inpaint

        def solve(x, mask, gs, gl):
            return segmentation_inpaint(x, mask, gs, gl, p=args.ar_order, maxit=args.maxit,
                                        method=args.ar_method, max_gap=max_gap)
    elif m in ("aspain_learned", "sspain_learned"):
        from ml_audio_inpainting_torch.classical.basisopt import aspain_learned, sspain_learned

        spec = cfg.data.spectrogram
        if args.basis:
            basis = torch.from_numpy(np.load(args.basis)["basis"]).to(torch.complex64)
        else:
            basis = torch.eye(spec.freq_bins, dtype=torch.complex64)
        basis = basis.to(device)
        core = aspain_learned if m == "aspain_learned" else sspain_learned

        def solve(x, mask, gs, gl):
            return core(x, mask, basis, maxit=max(args.maxit, 100), n_fft=spec.n_fft,
                        hop_length=spec.hop_length, win_length=spec.win_length)
    else:
        from ml_audio_inpainting_torch.classical.spain import spain_inpaint

        spain_maxit = max(args.maxit, 30 if m == "sspain_omp" else 100)

        def solve(x, mask, gs, gl):
            return spain_inpaint(x, mask, gs, gl, algorithm=m, maxit=spain_maxit,
                                 max_gap=max_gap)

    def runner(audio, gap_start, gap_len) -> torch.Tensor:
        if not torch.is_tensor(audio):
            audio = torch.as_tensor(audio, dtype=torch.float32)
        audio = audio.to(device)
        gs = torch.as_tensor(gap_start, dtype=torch.int64, device=device)
        gl = torch.as_tensor(gap_len, dtype=torch.int64, device=device)
        mask = gap_mask(audio.shape[-1], gs, gl, dtype=audio.dtype)
        return solve(audio * mask, mask, gs, gl)

    return runner


if __name__ == "__main__":
    main()

"""Evaluation CLI: the models' quality on a set of clips (port of
``ml_audio_inpainting_tpu/cli/evaluate.py``: every model of the JAX CLI and
per-clip test-time adaptation)::

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
a clip only (``--n-gaps > 1`` raises, as in JAX), and so do the
``refiner`` (which also refuses gaps over ``MAX_GAP`` samples) and
``--adapt-steps``.

``--golden DIR`` scores reconstructions of the reference held in ``DIR``
as ``{stem}_gan_inpainted.flac`` and ``{stem}_cnnlstm_inpainted.flac``
(files that are missing are skipped) and each of ``--models`` against
them, on the evaluation gap as ``model_eval.m`` cuts it
(:func:`matlab_gap_slice`): gap SDR per clip on the host, its difference
from each reconstruction's, and the RMS distance of the log1p-magnitude
spectrograms at 512/128/512 (:func:`spec_l2`, on the device).  A clip
named :data:`GOLDEN_ANCHOR` fills ``anchor_check`` against the recorded
scalars :data:`RECORDED_GAP_SDR`.  The payload has the JAX CLI's layout.

``--adapt-steps N`` fine-tunes a copy of the GAN on each clip before it is
served (``runtime/adapt.py``), the runner's own weights untouched; its
gaps are drawn on the device from a ``torch.Generator`` seeded
``--adapt-seed`` (JAX's from ``jax.random``), so the adapted outputs differ
from JAX's.  The JSON then carries ``condition["adapt"]`` and each clip's
``adapt_info``, as JAX's does.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["build_argparser", "main", "run", "load_clean", "gap_layout", "restore", "adapt",
           "score", "golden", "run_golden", "matlab_gap_slice", "golden_gap_sdr", "spec_l2"]

MULTI_GAP_SEED = 7
MIN_DIST_SAMPLES = 5000

#: model_comparison.mat's scalars, written by ``model_eval.m:60,84`` for the
#: anchor clip 81-121543-0008.flac.
RECORDED_GAP_SDR = {"cnnlstm": -2.12, "gan": -1.39}
GOLDEN_ANCHOR = "81-121543-0008"
GOLDEN_TAGS = ("gan", "cnnlstm")
#: the models' names -> the reference's reconstruction file tag
GOLDEN_TAG_OF_MODEL = {"gan": "gan", "cnn_blstm": "cnnlstm"}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate inpainting models")
    p.add_argument("--models", nargs="+", required=True,
                   help="gan, cnn_blstm, cnn_phase, cnn_phase_anchored, refiner and the "
                        "classical solvers (janssen, arinpaint, segmentation, aspain, sspain, "
                        "sspain_omp, aspain_learned, sspain_learned)")
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
                   help="per-clip test-time adaptation: fine-tune the GAN on each clip's own "
                        "context for N steps, in-clip probe gate (runtime/adapt.py); default "
                        "off")
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
                   help="directory of the reference's reconstructions ({stem}_gan_inpainted.flac, "
                        "{stem}_cnnlstm_inpainted.flac): score them, check the recorded "
                        "model_comparison.mat scalars, and compare --models against them "
                        "(gap-SDR deltas and spectrogram L2)")
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


def adapt(args, runner, clean: torch.Tensor, layout: dict, names: List[str]
          ) -> Tuple[torch.Tensor, dict]:
    """``--adapt-steps``: each clip served by the GAN adapted to it
    (``runtime/adapt.py::GanClipAdapter``) through the runner's serving
    function; returns ``(restored (B, S), {name: adapt info})``."""
    from ml_audio_inpainting_torch.runtime.adapt import GanClipAdapter

    adapter = GanClipAdapter(runner.cfg, runner.inpaint_factory, steps=args.adapt_steps,
                             lr=args.adapt_lr, batch=args.adapt_batch,
                             probe_every=args.adapt_probe_every, n_gaps=args.adapt_n_gaps,
                             ar_order=args.ar_order, ar_context=args.ar_context)
    gs, gl = layout["gs"], layout["gl"]
    outs, infos = [], {}
    for j, (s, n) in enumerate(zip(gs.tolist(), gl.tolist())):
        generator, info = adapter.adapt(runner.model, clean[j], s, n, seed=args.adapt_seed)
        outs.append(runner.inpaint_factory(generator)(clean[j:j + 1], gs[j:j + 1],
                                                      gl[j:j + 1])[0])
        infos[names[j]] = info
        print(f"adapt {names[j]}: best step {info['best_step']} probe {info['best_probe_sdr']} dB")
    return torch.cat(outs), infos


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _checked_config(args):
    """The config of ``args``, once the checkpoint is routed and the
    refusals the JAX CLI makes before ``--golden`` are made."""
    from ml_audio_inpainting_torch.cli.inpaint import check_ported, check_refiner_gap, route
    from ml_audio_inpainting_torch.utils.config import Config, load_config

    route(args)
    check_ported(args.models, args)
    cfg = load_config(args.config) if args.config else Config()
    if "refiner" in args.models:
        check_refiner_gap(args, cfg.data.sample_rate, flag="--models")
        if args.n_gaps > 1:
            raise SystemExit("--models refiner has no mask-driven multi-gap path; the sequential "
                             "fallback would feed the frozen GAN the other gaps' zeros as "
                             "signal. Use gan/cnn_blstm for --n-gaps.")
    return cfg


def run(args, timings: Optional[Dict[str, float]] = None, adapt_info: Optional[dict] = None
        ) -> Tuple[List[Path], Dict[str, Dict[str, np.ndarray]]]:
    """Everything :func:`main` does before it prints: the files and each
    model's per-clip metrics, unrounded.  With ``--adapt-steps``, each
    clip's adaptation info goes into ``adapt_info`` (a dict) under the
    file's stem.  With ``timings`` (a dict), the wall seconds of reading the
    files (``read``), of each model's build and restoration (``model``), its
    metrics (``metrics``) and the written reconstructions (``write``) are
    added to it, the device synchronised at each boundary."""
    from ml_audio_inpainting_torch.cli.inpaint import PHASE_MODELS, _build_runner, _collect
    from ml_audio_inpainting_torch.data.audio_io import save_audio

    cfg = _checked_config(args)
    sr = cfg.data.sample_rate
    if args.adapt_steps > 0 and args.n_gaps > 1:
        raise SystemExit("--adapt-steps has no multi-gap eval path yet")
    if args.n_gaps > 1 and set(PHASE_MODELS) & set(args.models):
        raise SystemExit("--models cnn_phase[_anchored] supports single-gap eval only")
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
        if args.adapt_steps > 0 and model_name == "gan":
            restored, infos = adapt(m_args, runner, clean, layout, [f.stem for f in files])
            if adapt_info is not None:
                adapt_info.update(infos)
        else:
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


def matlab_gap_slice(sr: int, gap_start_s: float, gap_len_s: float) -> slice:
    """The evaluation gap's samples as ``model_eval.m:33-36`` cuts them:
    MATLAB's 1-based inclusive ``temp(fs*2.0 : fs*2.08) = 0``."""
    start = int(sr * gap_start_s) - 1  # 1-based -> 0-based
    end = int(sr * (gap_start_s + gap_len_s))  # inclusive endpoint
    return slice(start, end + 1)


def golden_gap_sdr(clean: np.ndarray, restored: np.ndarray, gap: slice) -> float:
    """``snr(signal(gap), signal(gap) - solution(gap))`` (``model_eval.m:60``),
    on the host."""
    err = clean[..., gap] - restored[..., gap]
    num = float(np.sum(clean[..., gap] ** 2))
    return 10.0 * float(np.log10(num / (np.sum(err**2) + 1e-12)))


def spec_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """RMS distance between the log1p-magnitude spectrograms of two
    waveforms, always at the GAN's STFT (512/128/512), so that the number
    compares across model configs; reduced to one scalar on the inputs'
    device."""
    from ml_audio_inpainting_torch.ops.stft import stft

    mags = torch.log1p(stft(torch.stack([a, b]), n_fft=512, hop_length=128, win_length=512).abs())
    return float(torch.sqrt(torch.mean((mags[0] - mags[1]) ** 2)))


def _golden_entry(per_file: dict) -> dict:
    return {"gap_sdr_db": per_file,
            "mean_gap_sdr_db": round(float(np.mean(list(per_file.values()))), 3)}


def run_golden(args, cfg, files: List[Path], clean: np.ndarray) -> dict:
    """Score the reconstructions under ``args.golden`` and each of
    ``args.models`` against them; returns the JSON payload.  ``clean`` is
    the ``(n_files, S)`` clips on the host; the models run on
    ``args.device``."""
    from ml_audio_inpainting_torch.cli.inpaint import _build_runner
    from ml_audio_inpainting_torch.data.audio_io import load_audio

    sr = cfg.data.sample_rate
    golden_dir = Path(args.golden)
    gap = matlab_gap_slice(sr, args.gap_start, args.gap_len)

    reference_outputs: dict = {}
    ref_audio: dict = {}
    for tag in GOLDEN_TAGS:
        per_file = {}
        ref_audio[tag] = {}
        for j, f in enumerate(files):
            path = golden_dir / f"{f.stem}_{tag}_inpainted.flac"
            if not path.exists():
                continue
            rec = load_audio(path, sample_rate=sr, max_len=cfg.data.max_len_s)[0]
            ref_audio[tag][f.stem] = rec
            per_file[f.stem] = round(golden_gap_sdr(clean[j], rec, gap), 3)
        if per_file:
            reference_outputs[tag] = _golden_entry(per_file)

    anchor_check = {
        tag: {"recomputed_gap_sdr_db": reference_outputs[tag]["gap_sdr_db"].get(GOLDEN_ANCHOR),
              "recorded_gap_sdr_db": RECORDED_GAP_SDR[tag]}
        for tag in GOLDEN_TAGS
        if tag in reference_outputs and GOLDEN_ANCHOR in reference_outputs[tag]["gap_sdr_db"]
    }

    ours: dict = {}
    n_clips = len(files)
    clean_d = torch.from_numpy(clean).to(args.device)
    gs = torch.full((n_clips,), int(args.gap_start * sr), dtype=torch.int64, device=args.device)
    gl = torch.full((n_clips,), int(args.gap_len * sr), dtype=torch.int64, device=args.device)
    for model_name in args.models:
        m_args = argparse.Namespace(**vars(args))
        m_args.model = model_name
        restored_d = _build_runner(m_args, cfg)(clean_d, gs, gl)
        restored = restored_d.cpu().numpy()
        entry = _golden_entry({f.stem: round(golden_gap_sdr(clean[j], restored[j], gap), 3)
                               for j, f in enumerate(files)})
        per_file = entry["gap_sdr_db"]
        for tag, ref in reference_outputs.items():
            deltas = {stem: round(per_file[stem] - ref["gap_sdr_db"][stem], 3)
                      for stem in per_file if stem in ref["gap_sdr_db"]}
            l2 = {f.stem: round(spec_l2(restored_d[j], torch.from_numpy(
                      ref_audio[tag][f.stem]).to(args.device)), 4)
                  for j, f in enumerate(files) if f.stem in ref_audio[tag]}
            entry[f"delta_gap_sdr_vs_{tag}_db"] = deltas
            entry[f"mean_delta_vs_{tag}_db"] = round(float(np.mean(list(deltas.values()))), 3)
            entry[f"spec_l2_vs_{tag}"] = l2
        ours[model_name] = entry

    return {
        "condition": {
            "gap_start_s": args.gap_start,
            "gap_len_s": args.gap_len,
            "gap_slice": [gap.start, gap.stop],
            "gap_convention": "model_eval.m:33-36 (MATLAB 1-based inclusive)",
            "files": [f.name for f in files],
            "golden_dir": str(golden_dir),
        },
        "recorded_model_comparison": {
            "anchor": GOLDEN_ANCHOR,
            "gap_sdr_db": RECORDED_GAP_SDR,
            "source": "model_comparison.mat via model_eval.m:60 (SURVEY.md §6)",
        },
        "anchor_check": anchor_check,
        "reference_outputs": reference_outputs,
        "ours": ours,
    }


def golden(args) -> dict:
    """``--golden``: the checks :func:`run` makes first, the clips of
    ``--input``, and :func:`run_golden` over them."""
    from ml_audio_inpainting_torch.cli.inpaint import _collect

    cfg = _checked_config(args)
    files = _collect(Path(args.input))
    return run_golden(args, cfg, files, load_clean(files, cfg))


def _print_golden(payload: dict) -> None:
    for tag, chk in payload["anchor_check"].items():
        print(f"golden anchor {tag}: recomputed {chk['recomputed_gap_sdr_db']} dB vs recorded "
              f"{chk['recorded_gap_sdr_db']} dB")
    for name, entry in payload["ours"].items():
        line = f"{name}: mean gap-SDR {entry['mean_gap_sdr_db']} dB"
        for tag in GOLDEN_TAGS:
            k = f"mean_delta_vs_{tag}_db"
            if k in entry:
                line += f", vs {tag} {entry[k]:+} dB"
        print(line)


def main(argv=None) -> None:
    from ml_audio_inpainting_torch.train.peaq import ODG_MAPPING

    args = build_argparser().parse_args(argv)
    if args.golden:
        payload = golden(args)
        _print_golden(payload)
        if args.output_json:
            Path(args.output_json).write_text(json.dumps(payload, indent=2))
            print(f"wrote {args.output_json}")
        return
    adapt_info: dict = {}
    files, raw = run(args, adapt_info=adapt_info)
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
        if args.adapt_steps > 0:
            condition["adapt"] = {
                "steps": args.adapt_steps,
                "lr": args.adapt_lr,
                "batch": args.adapt_batch,
                "n_gaps": args.adapt_n_gaps,
                "probe_every": args.adapt_probe_every,
                "seed": args.adapt_seed,
            }
        condition["odg_mapping"] = ODG_MAPPING
        payload = {"condition": condition, "results": results}
        if adapt_info:
            payload["adapt_info"] = adapt_info
        Path(args.output_json).write_text(json.dumps(payload, indent=2))
        print(f"wrote {args.output_json}")


if __name__ == "__main__":
    main()

"""Per-condition probe tuning of the classical solvers (port of
``ml_audio_inpainting_tpu/cli/ar_tune.py``)::

    python -m ml_audio_inpainting_torch.cli.ar_tune --model arinpaint --gap-len 0.08 \\
        --probe-dir probe/ --contexts 4096 8192 --blends cos2 sigmoid:2 \\
        --output-json tune.json [--eval --input clips/] [--device cpu]

1. Sweep a grid of solver settings (``arinpaint``: context x order x blend;
   ``janssen``: context x order x iterations) over a probe set: every clip
   of ``--probe-dir`` once a gap position (``data/probe.py``), scored by
   the mean gap SDR (``train/metrics.py::gap_sdr``) of the inpaint CLI's
   runner (``cli/inpaint.py::_build_runner``) on ``--device``;
2. keep the best probe mean;
3. with ``--eval``, score the winner once on the clips of ``--input`` (gap
   at ``--gap-start``); ``--eval-all`` scores every grid point there too.

The JSON has the JAX CLI's layout (``grid`` rows with ``probe_mean_db`` and
``elapsed_s``, ``probe_best``, ``eval``).  ``--eval`` needs ``--input``
(the JAX CLI's default is a directory of the reference's samples).
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["build_argparser", "main", "grid", "solver"]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Probe-tune a classical solver for one gap condition")
    p.add_argument("--model", choices=["arinpaint", "janssen"], default="arinpaint")
    p.add_argument("--gap-len", type=float, required=True,
                   help="gap length (s) of the target condition")
    p.add_argument("--gap-start", type=float, default=2.0, help="eval gap start (s)")
    p.add_argument("--probe-dir", required=True,
                   help="directory of real held-out probe clips (never the eval clips)")
    p.add_argument("--probe-positions", type=float, nargs="+", default=[1.0, 1.5, 2.5, 3.0, 3.5],
                   help="gap start times (s) a probe clip")
    p.add_argument("--contexts", type=int, nargs="+", default=[4096, 8192, 16384])
    p.add_argument("--orders", type=int, nargs="+", default=[512])
    p.add_argument("--blends", nargs="+", default=["cos2", "linear:0.2", "sigmoid:2"],
                   help="arinpaint blend tokens: cos2 | linear:<floor> | sigmoid:<k>")
    p.add_argument("--maxits", type=int, nargs="+", default=[5, 10],
                   help="janssen iteration counts")
    p.add_argument("--ar-method", choices=["lpc", "arburg"], default="lpc")
    p.add_argument("--eval", action="store_true", help="score the probe winner on the eval clips")
    p.add_argument("--eval-all", action="store_true",
                   help="analysis only: score every grid point on the eval clips too, to see "
                        "how well the probe ranking transfers")
    p.add_argument("--input", default=None, help="eval clips directory (needed by --eval)")
    p.add_argument("--config", default=None)
    p.add_argument("--output-json", default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def _parse_blend(token: str):
    if ":" in token:
        fam, param = token.split(":", 1)
        return fam, float(param)
    return token, 0.0


def grid(args):
    """The solver settings of the sweep, in the JAX CLI's order."""
    if args.model == "arinpaint":
        for ctx, order, blend in itertools.product(args.contexts, args.orders, args.blends):
            fam, param = _parse_blend(blend)
            yield {"ar_context": ctx, "ar_order": order,
                   "ar_blend": fam, "ar_blend_param": param, "maxit": 10}
    else:
        for ctx, order, maxit in itertools.product(args.contexts, args.orders, args.maxits):
            yield {"ar_context": ctx, "ar_order": order, "maxit": maxit,
                   "ar_blend": "cos2", "ar_blend_param": 0.0}


def solver(args, conf: dict, cfg):
    """The runner of one grid point: the inpaint CLI's ``_build_runner``
    over a namespace of ``conf`` and the sweep's model, gap and device."""
    from ml_audio_inpainting_torch.cli.inpaint import _build_runner

    m_args = argparse.Namespace(
        model=args.model, gap_len=args.gap_len, ar_method=args.ar_method, config=args.config,
        checkpoint=None, infer_dtype="f32", ar_preset="default", device=args.device, **conf)
    return _build_runner(m_args, cfg)


def _condition(clips: np.ndarray, starts, gap_len: int, device) -> tuple:
    """``(audio, gs, gl, gap)`` on ``device``: the clips, their gaps, and
    the ``(B, S)`` mask that is 1 on the gap."""
    from ml_audio_inpainting_torch.ops.gaps import gap_mask

    audio = torch.from_numpy(np.ascontiguousarray(clips)).to(device)
    gs = torch.as_tensor(np.asarray(starts), dtype=torch.int64).to(device)
    gl = torch.full_like(gs, gap_len)
    return audio, gs, gl, 1.0 - gap_mask(audio.shape[-1], gs, gl)


def _score(runner, audio, gs, gl, gap) -> float:
    from ml_audio_inpainting_torch.train.metrics import gap_sdr

    return float(gap_sdr(audio, runner(audio, gs, gl), gap).mean())


def main(argv=None) -> dict:
    """Run the CLI; returns the JSON payload."""
    from ml_audio_inpainting_torch.cli.inpaint import _collect
    from ml_audio_inpainting_torch.data.probe import load_real_probe_set
    from ml_audio_inpainting_torch.utils.config import Config, load_config

    args = build_argparser().parse_args(argv)
    if (args.eval or args.eval_all) and not args.input:
        raise SystemExit("--eval/--eval-all need --input (the eval clips directory)")
    cfg = load_config(args.config) if args.config else Config()
    sr = cfg.data.sample_rate
    gap_len = int(args.gap_len * sr)

    clips, starts, n_files = load_real_probe_set(args.probe_dir, args.probe_positions, sr,
                                                 cfg.data.max_len_s, gap_len_s=args.gap_len)
    print(f"probe: {n_files} clips x {len(args.probe_positions)} positions, "
          f"gap {args.gap_len * 1000:.0f} ms")
    probe = _condition(clips, starts, gap_len, args.device)

    eval_pack = None
    if args.eval or args.eval_all:
        from ml_audio_inpainting_torch.cli.evaluate import load_clean

        files = _collect(Path(args.input))
        clean = load_clean(files, cfg)
        eval_pack = (files, _condition(clean, np.full(len(files), int(args.gap_start * sr)),
                                       gap_len, args.device))

    rows = []
    best = None
    for conf in grid(args):
        t0 = time.perf_counter()
        runner = solver(args, conf, cfg)
        probe_db = _score(runner, *probe)
        row = {**conf, "probe_mean_db": round(probe_db, 3),
               "elapsed_s": round(time.perf_counter() - t0, 1)}
        if args.eval_all:
            row["eval_mean_db"] = round(_score(runner, *eval_pack[1]), 3)
        rows.append(row)
        print(row)
        if best is None or probe_db > best[0]:
            best = (probe_db, conf, runner)

    probe_best, best_conf, best_runner = best
    print(f"probe winner: {best_conf} ({probe_best:.3f} dB)")
    out = {
        "what": (f"per-condition probe tuning of {args.model} at "
                 f"{args.gap_len * 1000:.0f} ms gaps"),
        "protocol": (f"{n_files} real probe clips x {len(args.probe_positions)} "
                     f"positions from {args.probe_dir} (disjoint from eval); "
                     f"winner optionally scored once on the eval clips"),
        "grid": rows,
        "probe_best": {**best_conf, "probe_mean_db": round(probe_best, 3)},
    }
    if eval_pack is not None:
        files, condition = eval_pack
        eval_db = _score(best_runner, *condition)
        out["eval"] = {"files": [f.name for f in files], "gap_start_s": args.gap_start,
                       "mean_gap_sdr_db": round(eval_db, 3)}
        print(f"eval ({len(files)} clips): {eval_db:.3f} dB")

    if args.output_json:
        Path(args.output_json).write_text(json.dumps(out, indent=1))
        print(f"wrote {args.output_json}")
    return out


if __name__ == "__main__":
    main()

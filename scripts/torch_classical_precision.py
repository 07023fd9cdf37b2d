"""How much the classical solvers depend on their floating-point type, on one
device::

    python3 -m scripts.torch_classical_precision [--device cpu]

For each solver of ``chip_smoke.py``'s phase ``classical`` (the ``inpaint``
CLI's runners at its defaults, and ``--ar-preset tuned``), on the phase's 32
clips of ``runtime/synthetic.py::synthetic_dataset_batch``: the per-clip
gap SDR of the f32 solve against the f64 one (median and largest |difference|,
non-finite clips), and how far the f64 solve of clips 0-1 moves when every
input sample moves by one ulp (the largest change in the gap over the gap's
peak).  Prints one JSON line.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ml_audio_inpainting_torch.cli import inpaint
from ml_audio_inpainting_torch.ops.gaps import gap_mask
from ml_audio_inpainting_torch.runtime.synthetic import (
    BATCH,
    GAP_LEN,
    GAP_START,
    synthetic_dataset_batch,
)
from ml_audio_inpainting_torch.train.metrics import gap_sdr
from ml_audio_inpainting_torch.utils.config import Config

__all__ = ["CLASSICAL_RUNS", "classical_runner", "main"]

CLASSICAL_RUNS = (  # (label, model, the inpaint CLI's flags, gap samples)
    ("arinpaint", "arinpaint", [], GAP_LEN),
    ("janssen", "janssen", [], GAP_LEN),
    ("segmentation", "segmentation", [], GAP_LEN),
    ("aspain", "aspain", [], GAP_LEN),
    ("sspain", "sspain", [], GAP_LEN),
    ("sspain_omp", "sspain_omp", [], GAP_LEN),
    ("aspain_learned", "aspain_learned", [], GAP_LEN),
    ("sspain_learned", "sspain_learned", [], GAP_LEN),
    ("arinpaint tuned", "arinpaint", ["--ar-preset", "tuned"], GAP_LEN),
    ("janssen tuned", "janssen", ["--ar-preset", "tuned"], GAP_LEN),
    ("janssen tuned 200 ms", "janssen", ["--ar-preset", "tuned", "--gap-len", "0.2"], 3200),
)


def classical_runner(model: str, flags: list, device: str):
    """The solver as the ``inpaint`` CLI builds it, on ``device``."""
    args = inpaint.build_argparser().parse_args(
        ["--model", model, "--input", "-", "--output", "-", "--device", device, *flags])
    return inpaint._build_runner(args, Config())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to measure on the CPU")
    audio = torch.tensor(synthetic_dataset_batch(BATCH), dtype=torch.float64, device=device)
    signs = np.random.default_rng(0).choice([-1.0, 1.0], audio[:2].shape)
    nudged = audio[:2] * (1 + np.finfo(np.float64).eps * torch.tensor(signs, device=device))
    out = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "batch": BATCH, "runs": {}}
    for label, model, flags, gap_len in CLASSICAL_RUNS:
        t0 = time.perf_counter()
        runner = classical_runner(model, flags, args.device)
        gs = torch.full((BATCH,), GAP_START, device=device)
        gl = torch.full((BATCH,), gap_len, device=device)
        gap = 1.0 - gap_mask(audio.shape[-1], gs, gl, dtype=torch.float64)
        out64 = runner(audio, gs, gl)
        out32 = runner(audio.float(), gs, gl).double()
        d = (gap_sdr(audio, out32, gap) - gap_sdr(audio, out64, gap)).abs().cpu()
        moved = runner(nudged, gs[:2], gl[:2])
        g = gap[:2] > 0
        ulp = ((moved - out64[:2]).abs()[g].max() / out64[:2].abs()[g].max()).item()
        out["runs"][label] = {
            "f32_vs_f64_median_db": d.nanmedian().item(),
            "f32_vs_f64_max_db": d.nan_to_num(0).max().item(),
            "f32_non_finite_clips": int((~torch.isfinite(out32).all(-1)).sum()),
            "one_ulp_moves_gap_by": ulp, "seconds": time.perf_counter() - t0,
        }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

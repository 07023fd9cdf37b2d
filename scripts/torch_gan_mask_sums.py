#!/usr/bin/env python3
"""Whether the PConv U-Net's mask sums are exact on a CUDA card.

    python3 -m scripts.torch_gan_mask_sums    # from the repo root

Each partial convolution renormalises by the window sums of its mask's
channel sum (``_ones_conv`` in the JAX package).  This script runs the GAN
runner's generator (``gan_formant_v2_r2.npz``, ``chip_smoke.py``'s clips and
gap, ``BATCH`` rows) in f32 and in bf16 and, at every partial convolution,
computes those sums two ways: by a convolution with an all-ones kernel
(cuDNN, the JAX package's formulation) and by the port's sum pool
(``models/pconv_unet.py::ones_conv``).  Each is held against the exact sums
(in f64, rounded once to the dtype): the largest difference and the number
of positions where the exact sum is 0 and the computed one is not.  It also
runs the generator twice and reports how far its output moved.  Prints one
JSON object.  Imports nothing of JAX.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ml_audio_inpainting_torch.models.pconv_unet import PartialConv, ones_conv
from ml_audio_inpainting_torch.runtime.serve import make_gan_runner
from ml_audio_inpainting_torch.runtime.synthetic import (
    GAP_LEN,
    GAP_START,
    gan_config,
    synthetic_dataset_batch,
)

REPO = Path(__file__).resolve().parents[1]
CHECKPOINT = REPO / "results" / "checkpoints" / "gan_formant_v2_r2.npz"
BATCH = 4


def probe(dtype) -> dict:
    cfg = gan_config()
    runner = make_gan_runner(cfg, CHECKPOINT, device="cuda", compute_dtype=dtype)
    # the module the function applies: the bf16 copy, or the generator itself
    net = inspect.getclosurevars(runner.inpaint_fn.__wrapped__).nonlocals["net"]
    audio = torch.tensor(synthetic_dataset_batch(BATCH, cfg.data.max_len_s), device="cuda")
    starts = torch.full((BATCH,), GAP_START, device="cuda")
    lens = torch.full((BATCH,), GAP_LEN, device="cuda")
    layers = {}

    def hook(name):
        def record(mod, inputs, _):
            mask_sum = inputs[2]
            exact = F.avg_pool2d(mask_sum.double(), mod.kernel, mod.stride, mod.pad,
                                 count_include_pad=True, divisor_override=1).to(mask_sum.dtype)
            ones = torch.ones(1, 1, mod.kernel, mod.kernel, dtype=mask_sum.dtype,
                              device=mask_sum.device)
            ways = {"conv": F.conv2d(mask_sum, ones, stride=mod.stride, padding=mod.pad),
                    "sum_pool": ones_conv(mask_sum, mod.kernel, mod.stride, mod.pad)}
            layers[name] = {
                way: {"max_abs_err": (got.double() - exact.double()).abs().max().item(),
                      "nonzero_where_exact_zero": ((exact == 0) & (got != 0)).sum().item()}
                for way, got in ways.items()}
        return record

    handles = [m.register_forward_hook(hook(n)) for n, m in net.named_modules()
               if isinstance(m, PartialConv)]
    with torch.inference_mode():
        first = runner.inpaint_fn(audio, starts, lens)[1]
        for h in handles:
            h.remove()
        again = runner.inpaint_fn(audio, starts, lens)[1]
    return {"layers": layers,
            "generated_moved_between_calls": (first - again).abs().max().item()}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script probes the port on a card")
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"card": smi, "batch": BATCH, "f32": probe(None),
                      "bf16": probe(torch.bfloat16)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

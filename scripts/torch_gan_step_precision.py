#!/usr/bin/env python3
"""The readings behind the bounds of the port's GAN training checks on a card.

    python3 -m scripts.torch_gan_step_precision             # from the repo root, on a CUDA card
    python3 -m scripts.torch_gan_step_precision --tiny 4    # tests/test_torch_gpu.py's tiny step

By default takes step 0 of ``chip_smoke.py``'s ``gan_training`` check batch
(the first 2 clips of its first formant_v2 batch, 4 gaps each, VGG19 on; G
from the committed ``gan_formant_v2_r2.npz``, D seeded); with ``--tiny N``,
``tests/test_torch_gpu.py::test_gan_step_on_card_matches_cpu``'s step
(``tiny_gan_config``'s widths, 1 s clips, N gaps a clip, VGG off, both
networks seeded).  Runs it through the port's train step: f64 on the CPU
(the reference); f32 on the CPU, and on the card (TF32 off) under each
cuDNN setting of ``CUDNN``; f64 on the CPU again, replaying the branches
the CPU's and the card's f32 steps took at each kink
(``utils/branch_tape.py``); bf16 on the CPU and on the card; and the
control, the bf16 step with every cast rounded through float8_e5m2, on both.
Prints one JSON object, with the card's name and power limit:

* each f32 step against the f64 one, and against the f64 one that took
  its branches: the losses' largest relative distance, and every
  gradient's largest distance over its scale
  (``chip_smoke.py::f32_grad_errors``);
* how many kink inputs took another branch in each f32 step than in the
  f64 step, by kind (LeakyReLU, ReLU, max pool);
* each bf16 step and control against the f32 step on the same device:
  ``chip_smoke.py::bf16_readings`` (losses, every gradient by its L2 norm,
  u, sigma), and what of it lies outside ``chip_smoke.py``'s bounds;
* the seconds of each step.

Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke
from ml_audio_inpainting_torch.runtime.synthetic import gan_config, speech_like_batch
from ml_audio_inpainting_torch.train.gan_trainer import create_gan_states
from ml_audio_inpainting_torch.train.recipe import gan_gap_layouts, gan_recipe_config

# cuDNN settings of the card's f32 step: chip_smoke.py's (heuristic
# algorithms), only deterministic algorithms, autotuned ones, and cuDNN off
# (PyTorch's own CUDA convolutions).
CUDNN = {"default": {}, "deterministic": {"deterministic": True},
         "benchmark": {"benchmark": True}, "off": {"enabled": False}}


def tiny_case(n_gaps: int) -> tuple:
    """(config, batch, states) of the tiny ``gpu`` test: its widths, clips,
    gaps and seeds."""
    cfg = gan_config()
    cfg.data.max_len_s, cfg.data.gap_len_s, cfg.data.train_n_gaps = 1.0, 0.1, n_gaps
    cfg.model.generator.enc_layer_cfg = [(8, 7, 2), (16, 5, 2), (16, 3, 2)]
    cfg.model.generator.dec_layer_cfg = [(16, 3, 1), (8, 3, 1)]
    cfg.model.generator.final_interim_ch = 8
    cfg.model.discriminator.layer_cfg = [(8, 2), (16, 2)]
    cfg.training.lambda_vgg_perceptual = cfg.training.lambda_vgg_style = 0.0
    audio = torch.tensor(speech_like_batch(np.random.default_rng(3), 2)[:, :cfg.data.max_samples])
    gaps = list(gan_gap_layouts(torch.Generator().manual_seed(4), cfg, 2))

    def states(cfg, device):
        return create_gan_states(cfg, device=device, generator=torch.Generator().manual_seed(2))
    return cfg, (audio, gaps), states


def other_branches(tape: list, reference: list) -> dict:
    """How many kink inputs of ``tape`` took another branch than in
    ``reference`` (the same step's calls), by kind."""
    out = {"leaky_relu_or_relu": 0, "max_pool": 0}
    for a, b in zip(tape, reference, strict=True):
        kind = "max_pool" if a.dtype == torch.int64 else "leaky_relu_or_relu"
        out[kind] += int((a.cpu() != b.cpu()).sum())
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tiny", type=int, default=0, metavar="N",
                        help="the tiny gpu test's step with N gaps a clip")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script reads the port's GAN step on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if args.tiny:
        cfg, batch, states = tiny_case(args.tiny)
    else:
        cfg, states = gan_recipe_config(), chip_smoke._gan_states
        batch = chip_smoke.gan_check_batch(chip_smoke.gan_training_batches(cfg)[0])
    card = chip_smoke.DEVICE
    tapes = {"cpu_f64": [], "cpu_f32": [], "card_f32_cudnn_default": []}
    runs = [("cpu_f64", "cpu", torch.float64, None, False, {}, None),
            ("cpu_f32", "cpu", torch.float32, None, False, {}, None)]
    runs += [(f"card_f32_cudnn_{k}", card, torch.float32, None, False, v, None)
             for k, v in CUDNN.items()]
    runs += [("cpu_f64_replaying_cpu_f32", "cpu", torch.float64, None, False, {}, "cpu_f32"),
             ("cpu_f64_replaying_card_f32", "cpu", torch.float64, None, False, {},
              "card_f32_cudnn_default"),
             ("cpu_bf16", "cpu", torch.float32, torch.bfloat16, False, {}, None),
             ("card_bf16", card, torch.float32, torch.bfloat16, False, {}, None),
             ("cpu_control", "cpu", torch.float32, torch.bfloat16, True, {}, None),
             ("card_control", card, torch.float32, torch.bfloat16, True, {}, None)]
    steps, seconds = {}, {}
    for name, device, dtype, compute_dtype, control, cudnn, replaying in runs:
        t0 = time.perf_counter()
        with torch.backends.cudnn.flags(**{"enabled": True, "benchmark": False,
                                           "deterministic": False, "allow_tf32": False,
                                           **cudnn}):
            steps[name] = chip_smoke.gan_step0(
                cfg, batch, device, dtype, compute_dtype, control=control, states=states,
                tape=tapes[replaying] if replaying else tapes.get(name), replay=bool(replaying))
        seconds[name] = time.perf_counter() - t0
    ref = steps["cpu_f64"]
    out = {"card": smi, "case": f"tiny, {args.tiny} gaps" if args.tiny else "chip_smoke",
           "clips": batch[0].shape[0], "seconds": seconds}
    for name in ["cpu_f32"] + [f"card_f32_cudnn_{k}" for k in CUDNN]:
        m = steps[name][0]
        out[name] = {"loss": max(abs(m[k] - v) / abs(v) for k, v in ref[0].items() if v),
                     "grad": chip_smoke.f32_grad_errors(steps[name][1], ref[1])}
    for name in ("cpu_f32", "card_f32_cudnn_default"):
        replayed = steps[f"cpu_f64_replaying_{name.removesuffix('_cudnn_default')}"]
        m = steps[name][0]
        out[f"{name}_vs_f64_on_its_branches"] = {
            "loss": max(abs(m[k] - v) / abs(v) for k, v in replayed[0].items() if v),
            "grad": chip_smoke.f32_grad_errors(steps[name][1], replayed[1]),
            "other_branches": other_branches(tapes[name], tapes["cpu_f64"])}
    f32 = {"cpu": steps["cpu_f32"], "card": steps["card_f32_cudnn_default"]}
    for side in ("cpu", "card"):
        for kind in ("bf16", "control"):
            r = chip_smoke.bf16_readings(steps[f"{side}_{kind}"], f32[side])
            out[f"{side}_{kind}"] = {**r, "outside": chip_smoke.bf16_outside(r)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

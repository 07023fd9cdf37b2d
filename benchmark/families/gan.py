"""The GAN family (the PConv U-Net generator): the program's serving entry
point built from the benchmark's configuration and seeded weights, and the
plain reference beside it.

Serving enters through ``runtime/serve.py::make_gan_runner`` with the
cell's ``mode``, the mix's phase regime and patch window, and the cell's
element type; its checkpoint loader is handed the generator that holds the
benchmark's weights (the runner reads no file).
"""

from __future__ import annotations

from types import SimpleNamespace
from unittest import mock

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import spec
from benchmark import weights as bw
from benchmark.reference import gan_serve, pconv_unet

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def ref_config(config: dict) -> dict:
    """The flat numbers the plain reference reads."""
    stft_cfg, gen = config["data"]["spectrogram"], config["model"]["generator"]
    return {"n_fft": stft_cfg["n_fft"], "hop_length": stft_cfg["hop_length"],
            "win_length": stft_cfg["win_length"], "sample_rate": config["data"]["sample_rate"],
            "samples": int(config["data"]["sample_rate"] * config["data"]["max_len_s"]),
            "enc_layer_cfg": [tuple(x) for x in gen["enc_layer_cfg"]],
            "dec_layer_cfg": [tuple(x) for x in gen["dec_layer_cfg"]],
            "final_interim_ch": gen["final_interim_ch"], "final_kernel": gen["final_kernel"]}


def generator_shapes(rc: dict) -> dict:
    return pconv_unet.param_shapes(rc["enc_layer_cfg"], rc["dec_layer_cfg"],
                                   rc["final_interim_ch"], rc["final_kernel"])


def generator_flops(rc: dict, batch: int) -> float:
    """FLOPs of one generator forward at ``batch`` clips, counted on the
    meta device over the plain reference."""
    sd = {k: torch.empty(shape, device="meta", dtype=torch.int64 if kind == "count" else None)
          for k, (kind, shape) in generator_shapes(rc).items()}
    frames = 1 + rc["samples"] // rc["hop_length"]
    x = torch.empty((batch, rc["n_fft"] // 2 + 1, frames), device="meta")
    with FlopCounterMode(display=False) as counter:
        pconv_unet.forward(sd, x, torch.empty_like(x), rc["enc_layer_cfg"], rc["dec_layer_cfg"])
    return float(counter.get_total_flops())


def server(cell, gen: torch.Generator, device) -> SimpleNamespace:
    """The runner of the cell, the weights it serves, and the plain
    reference of one request."""
    from ml_audio_inpainting_torch.models.build import build_generator
    from ml_audio_inpainting_torch.runtime import serve

    if (cell.settings["mode"], cell.mix["phase"]) != ("enhanced", "extrapolate"):
        raise ValueError("the plain reference serves mode 'enhanced' under phase 'extrapolate'")
    rc = ref_config(cell.config)
    cfg = spec.program_config(cell.config)
    sd = bw.materialize(generator_shapes(rc), gen, device)
    generator = build_generator(cfg, device)
    generator.load_state_dict(sd)
    generator.eval()
    dtype = cell.settings["dtype"]
    with mock.patch.object(serve, "load_generator", lambda *args, **kwargs: generator):
        runner = serve.make_gan_runner(cfg, None, device=device, mode=cell.settings["mode"],
                                       phase=cell.mix["phase"], compute_dtype=DTYPES[dtype],
                                       transport_window=cell.mix["patch_window"])

    def reference(audio, gap_start, gap_len, q=pconv_unet._identity):
        return gan_serve.serve(sd, rc, audio, gap_start, gap_len, cell.mix["patch_window"], q)

    return SimpleNamespace(runner=runner, reference=reference, dtype=dtype,
                           flops=generator_flops(rc, cell.mix["batch"]), samples=rc["samples"],
                           sample_rate=rc["sample_rate"])

"""The CNN+BiLSTM family: the program's entry points built from the
benchmark's configuration and seeded weights, and the plain reference
beside them.

Serving enters through ``runtime/serve.py::make_cnn_runner`` under the
mix's phase regime, its inpaint function wrapped in
``runtime/transport.py::make_gap_transport_fn`` (the runner has no patch
transport of its own); its checkpoint loader is handed the model that holds
the benchmark's weights (the runner reads no file).
"""

from __future__ import annotations

from types import SimpleNamespace
from unittest import mock

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import spec
from benchmark import weights as bw
from benchmark import yardstick
from benchmark.reference import cnn_blstm, cnn_serve, cnn_train, quant

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
# The training step's output kernel at 1/8 of the plain draw.  At the plain
# draw the predicted log10 magnitudes spread with a standard deviation near
# 0.7, so a few of a batch's ~14 M bins reach 10 ** 4.8, far above any
# target; those bins carry most of the loss and its gradient, and bf16's
# rounding of them swings every comparison with the draw's extremes.
OUTPUT_INIT_SCALE = 0.125


def ref_config(config: dict) -> dict:
    """The flat numbers the plain reference reads."""
    stft_cfg, model = config["data"]["spectrogram"], config["model"]
    return {"n_fft": stft_cfg["n_fft"], "hop_length": stft_cfg["hop_length"],
            "win_length": stft_cfg["win_length"], "sample_rate": config["data"]["sample_rate"],
            "samples": int(config["data"]["sample_rate"] * config["data"]["max_len_s"]),
            "freq_bins": stft_cfg["n_fft"] // 2 + 1, "num_lstm_layers": model["num_lstm_layers"],
            "hidden": model["lstm_hidden_dim"], "enc_filters": list(model["enc_filters"]),
            "dec_filters": list(model["dec_filters"]), "in_channels": model["in_channels"]}


def shapes(rc: dict) -> dict:
    return cnn_blstm.param_shapes(rc["freq_bins"], rc["enc_filters"], rc["dec_filters"],
                                  rc["hidden"], rc["num_lstm_layers"], rc["in_channels"])


def frames(rc: dict) -> int:
    return 1 + rc["samples"] // rc["hop_length"]


def meta_weights(rc: dict, requires_grad: bool = False) -> dict:
    return {k: torch.empty(shape, device="meta", dtype=torch.int64 if kind == "count" else None,
                           requires_grad=requires_grad and kind not in ("count",))
            for k, (kind, shape) in shapes(rc).items()}


def model_flops(rc: dict, batch: int, backward: bool = False) -> float:
    """FLOPs of one forward (and with ``backward`` its backward too) of the
    plain reference at ``batch`` rows, counted on the meta device.  Every
    layer's work is linear in the number of frames (SAME convolutions, a
    product a frame), so the count at 2 and 3 frames extrapolates exactly
    to the clip's; counting the 417-step recurrence itself takes seconds."""

    def count(n_frames: int) -> int:
        sd = meta_weights(rc, requires_grad=backward)
        x = torch.empty((batch, rc["freq_bins"], n_frames), device="meta")
        with FlopCounterMode(display=False) as counter:
            out = cnn_blstm.forward(sd, x, rc["num_lstm_layers"], len(rc["enc_filters"]) + 1,
                                    train=backward)
            if backward:
                out.sum().backward()
        return counter.get_total_flops()

    two, three = count(2), count(3)
    return float(two + (three - two) * (frames(rc) - 2))


def lstm_least(rc: dict, rows: int, dtype: str, training: bool) -> dict:
    """Least seconds of a forward call and of a backward call of one layer
    at ``rows`` sequences (:mod:`benchmark.yardstick`)."""
    t, h = frames(rc), rc["hidden"]
    fwd = yardstick.least_seconds(*yardstick.lstm_forward_work(rows, t, h, dtype, training), dtype)
    bwd = yardstick.least_seconds(*yardstick.lstm_backward_work(rows, t, h, dtype), dtype)
    return {"fwd_s": fwd, "bwd_s": bwd}


def server(cell, gen: torch.Generator, device) -> SimpleNamespace:
    """The runner of the cell, the weights it serves, and the plain
    reference of one request."""
    from ml_audio_inpainting_torch.models.build import build_model
    from ml_audio_inpainting_torch.runtime import serve
    from ml_audio_inpainting_torch.runtime.transport import make_gap_transport_fn

    if cell.mix["phase"] != "extrapolate" or cell.settings["dtype"] != "float32":
        raise ValueError("the plain reference serves the f32 model under phase 'extrapolate'")
    rc = ref_config(cell.config)
    cfg = spec.program_config(cell.config)
    sd = bw.materialize(shapes(rc), gen, device)
    model = build_model(cfg, device)
    model.load_state_dict(sd)
    model.eval()
    with mock.patch.object(serve, "load_cnn_model", lambda *args, **kwargs: model):
        runner = serve.make_cnn_runner(cfg, None, device=device, phase=cell.mix["phase"])
    transported = make_gap_transport_fn(runner.inpaint_fn, cell.mix["patch_window"])

    def reference(audio, gap_start, gap_len, q=cnn_blstm._identity):
        return cnn_serve.serve(sd, rc, audio, gap_start, gap_len, cell.mix["patch_window"], q)

    return SimpleNamespace(runner=transported, reference=reference, dtype="float32",
                           flops=model_flops(rc, cell.mix["batch"]), samples=rc["samples"],
                           sample_rate=rc["sample_rate"],
                           lstm=lstm_least(rc, cell.mix["batch"], "float32", False))


def trainer(cell, gen: torch.Generator, device) -> SimpleNamespace:
    """The program's train step of the cell (``make_cnn_train_step`` over the
    state that ``create_cnn_state`` builds, its weights replaced by the
    benchmark's), what the loop reads of its state, and the plain
    reference's steps.

    The output convolution's seeded kernel is scaled by
    :data:`OUTPUT_INIT_SCALE`."""
    from ml_audio_inpainting_torch.train.cnn_trainer import create_cnn_state, make_cnn_train_step

    recipe = cell.settings["recipe"]
    rc = ref_config(cell.config)
    cfg = spec.program_config(cell.config, recipe)
    sd = bw.materialize(shapes(rc), gen, device)
    sd["dec_conv2.weight"] = sd["dec_conv2.weight"] * OUTPUT_INIT_SCALE
    state = create_cnn_state(cfg, device=device)
    state.model.load_state_dict(sd)
    step_fn = make_cnn_train_step(cfg, compute_dtype=DTYPES[cell.settings["dtype"]])
    names = [n for n, _ in state.model.named_parameters()]
    lr = cfg.training.starter_learning_rate
    holder = {"state": state}
    rows = cfg.training.batch_size * cfg.data.gaps_per_audio

    def step(audio, starts, lengths):
        return step_fn(holder["state"], audio, starts, lengths)[1]["loss"]

    def first_gradients():
        st = holder["state"]
        beta1 = st.optimizer.param_groups[0]["betas"][0]
        return {n: st.optimizer.state[p]["exp_avg"].detach().float() / (1.0 - beta1)
                for n, p in st.model.named_parameters()}

    def snapshot():
        return {n: p.detach().clone() for n, p in holder["state"].model.named_parameters()}

    def free():
        holder["state"] = None

    def reference(batches, control=None, half=False):
        q, scope, dtype = quant.CONTROLS[control] if control else (
            quant.identity, quant.full_f32, None)
        with scope():
            return cnn_train.train(sd, rc, batches, lr, q, half, dtype)

    return SimpleNamespace(
        step=step, first_gradients=first_gradients, snapshot=snapshot, free=free,
        reference=reference, initial={n: sd[n].clone() for n in names},
        batch=cfg.training.batch_size, gap_shape=(cfg.training.batch_size, cfg.data.gaps_per_audio),
        n_gaps=cfg.data.train_n_gaps, gap_ms_max=1000.0 * cfg.data.gap_len_s,
        samples=rc["samples"], sample_rate=rc["sample_rate"], dtype=cell.settings["dtype"],
        flops=model_flops(rc, rows, backward=True),
        lstm=lstm_least(rc, rows, cell.settings["dtype"], True), resident=0)

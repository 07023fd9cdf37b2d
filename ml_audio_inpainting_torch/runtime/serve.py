"""Serving runners: the GAN, the CNN+BiLSTM and the phase-mode CNN+BiLSTM
(port of ``ml_audio_inpainting_tpu/cli/inpaint.py::_build_runner``, with the
GAN's gap-only PCM16 transport of ``bench.py``'s canonical line).  The
command-line runner over audio files, ``cli/inpaint.py::_build_runner``,
builds on these.

A checkpoint is any of what the JAX CLI serves (``cli/inpaint.py:292-380``):

* an exported ``.npz`` (flax variables), loaded strictly into the model of
  the config;
* a reference PyTorch ``.pt``/``.pth`` ``state_dict``
  (``models/port_torch.py``; the widths come from the file);
* a directory of the port's ``train/checkpoints.py::CheckpointManager``:
  the latest step's live weights and running statistics (what the JAX CLI
  serves from an orbax directory; not the EMA);
* None: fresh weights from the port's initialiser seeded 0 (the JAX CLI
  draws its own from ``PRNGKey(0)``, which cannot be reproduced).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Union

import torch

from ml_audio_inpainting_torch.models.build import build_generator, build_model
from ml_audio_inpainting_torch.models.cnn_blstm import StackedBLSTMCNN
from ml_audio_inpainting_torch.models.pconv_unet import PConvUNet
from ml_audio_inpainting_torch.runtime.inference import (
    make_cnn_inpaint_fn,
    make_cnn_phase_inpaint_fn,
    make_gan_inpaint_fn,
)
from ml_audio_inpainting_torch.runtime.transport import make_gap_transport_fn
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.utils.precision import full_f32_convolutions
from ml_audio_inpainting_torch.weights import (
    cnn_blstm_state_dict,
    load_params_npz,
    pconv_unet_state_dict,
)

__all__ = ["make_gan_runner", "make_cnn_runner", "make_cnn_phase_runner", "load_cnn_model",
           "load_generator", "checkpoint_kind", "FRESH_SEED"]

FRESH_SEED = 0  # the seed of the weights served with no checkpoint

Checkpoint = Optional[Union[str, Path]]


def checkpoint_kind(checkpoint: Checkpoint) -> str:
    """``"none"``, ``"npz"``, ``"pt"`` (``.pt``/``.pth``) or ``"dir"``."""
    if checkpoint is None:
        return "none"
    name = str(checkpoint)
    if name.endswith(".npz"):
        return "npz"
    if name.endswith((".pt", ".pth")):
        return "pt"
    if Path(name).is_dir():
        return "dir"
    raise ValueError(f"checkpoint {name!r} is not an .npz, a .pt/.pth file or a checkpoint "
                     "directory")


def _manager_model_state(checkpoint, key: Optional[str]) -> dict:
    from ml_audio_inpainting_torch.train.checkpoints import CheckpointManager

    tree = CheckpointManager(checkpoint).load_tree()
    return (tree[key] if key else tree)["model"]


def load_cnn_model(cfg: Config, checkpoint: Checkpoint, device="cuda") -> StackedBLSTMCNN:
    """The CNN+BiLSTM of ``checkpoint`` (any kind of the module docstring)
    on ``device`` in eval mode; the model of ``cfg`` except for a ``.pt``,
    whose widths are its own (its frequency bins ``cfg``'s)."""
    kind = checkpoint_kind(checkpoint)
    if kind == "pt":
        from ml_audio_inpainting_torch.models.port_torch import load_torch_cnn_blstm

        return load_torch_cnn_blstm(checkpoint, freq_bins=cfg.data.spectrogram.freq_bins,
                                    device=device)[0]
    model = build_model(cfg, device)
    if kind == "npz":
        model.load_state_dict(cnn_blstm_state_dict(load_params_npz(checkpoint)))
    elif kind == "dir":
        model.load_state_dict(_manager_model_state(checkpoint, None))
    else:
        model.init_weights(torch.Generator().manual_seed(FRESH_SEED))
    return model.eval()


def load_generator(cfg: Config, checkpoint: Checkpoint, device="cuda") -> PConvUNet:
    """The GAN generator of ``checkpoint`` (any kind of the module
    docstring; a directory holds ``{"g", "d"}``) on ``device`` in eval
    mode, with ``cfg``'s widths."""
    kind = checkpoint_kind(checkpoint)
    g = cfg.model.generator
    if kind == "pt":
        from ml_audio_inpainting_torch.models.port_torch import load_torch_pconv_unet

        return load_torch_pconv_unet(checkpoint, g.enc_layer_cfg, g.dec_layer_cfg,
                                     g.final_interim_ch, device=device)[0]
    generator = build_generator(cfg, device)
    if kind == "npz":
        generator.load_state_dict(pconv_unet_state_dict(load_params_npz(checkpoint)))
    elif kind == "dir":
        generator.load_state_dict(_manager_model_state(checkpoint, "g"))
    else:
        generator.init_weights(torch.Generator().manual_seed(FRESH_SEED))
    return generator.eval()


def _runner(fn: Callable, device, unwrap: bool = True) -> Callable:
    """``runner(audio, gap_start, gap_len)``: numpy arrays or tensors onto
    ``device`` (f32 audio, int64 gaps), ``fn`` with full-f32 convolutions,
    its first output when ``unwrap``."""

    def runner(audio, gap_start, gap_len):
        audio = torch.as_tensor(audio, dtype=torch.float32, device=device)
        gs = torch.as_tensor(gap_start, dtype=torch.int64, device=device)
        gl = torch.as_tensor(gap_len, dtype=torch.int64, device=device)
        with full_f32_convolutions():  # bf16 convolutions are not affected
            out = fn(audio, gs, gl)
        return out[0] if unwrap else out

    return runner


def make_gan_runner(
    cfg: Config,
    checkpoint: Checkpoint,
    device="cuda",
    mode: str = "enhanced",
    phase: str = "oracle",
    compute_dtype: Optional[torch.dtype] = None,
    transport_window: Optional[int] = None,
    gl_iters: int = 64,
) -> Callable:
    """``runner(audio, gap_start, gap_len)`` on ``device``: the ``(B, S)``
    restored waveforms or, with ``transport_window`` set, the gap-only PCM16
    payload ``(patch, start)`` of :func:`make_gap_transport_fn`.

    ``audio`` is ``(B, S)`` f32 waveforms and ``gap_start``/``gap_len`` are
    ``(B,)`` sample counts, as numpy arrays or tensors.  The generator is
    :func:`load_generator`'s.  In f32 its convolutions run in full f32 (TF32
    off in a scope), as the JAX reference on the CPU does;
    ``compute_dtype=torch.bfloat16`` runs the generator in bf16
    (:func:`make_gan_inpaint_fn`).  ``phase`` is any of the four regimes;
    ``gl_iters`` counts Griffin-Lim's iterations under ``"griffinlim"``.
    ``runner.inpaint_fn`` (the un-transported function), ``runner.generator``
    and ``runner.cfg`` expose the pieces.
    """
    generator = load_generator(cfg, checkpoint, device)
    inpaint_fn = make_gan_inpaint_fn(cfg, generator, mode=mode, compute_dtype=compute_dtype,
                                     phase=phase, gl_iters=gl_iters)
    if transport_window is None:
        runner = _runner(inpaint_fn, device)
    else:
        runner = _runner(make_gap_transport_fn(inpaint_fn, transport_window), device,
                         unwrap=False)
    runner.inpaint_fn = inpaint_fn
    runner.generator = generator
    runner.cfg = cfg
    return runner


def make_cnn_runner(
    cfg: Config,
    checkpoint: Checkpoint,
    device="cuda",
    phase: str = "oracle",
    gl_iters: int = 64,
) -> Callable:
    """``runner(audio, gap_start, gap_len) -> restored`` on ``device``.

    ``audio`` is ``(B, S)`` f32 waveforms and ``gap_start``/``gap_len`` are
    ``(B,)`` sample counts, as numpy arrays or tensors; ``restored`` is a
    ``(B, S)`` tensor on ``device``.  The model is :func:`load_cnn_model`'s
    (an ``.npz`` loads strictly, so a config that does not match the weights
    raises).  The convolutions run in full f32 (TF32 off in a scope), as
    the JAX reference on the CPU does.  ``phase`` and ``gl_iters`` as for
    :func:`make_gan_runner`.  ``runner.inpaint_fn``, ``runner.model`` and
    ``runner.cfg`` expose the pieces.
    """
    model = load_cnn_model(cfg, checkpoint, device)
    fn = make_cnn_inpaint_fn(cfg, model, phase=phase, gl_iters=gl_iters)
    runner = _runner(fn, device)
    runner.inpaint_fn = fn
    runner.model = model
    runner.cfg = cfg
    return runner


def make_cnn_phase_runner(
    cfg: Config,
    checkpoint: Checkpoint,
    device="cuda",
    anchored: bool = False,
) -> Callable:
    """``runner(audio, gap_start, gap_len) -> restored`` of the phase-mode
    CNN+BiLSTM (``cfg.model.cnn_blstm.in_channels == 2``), as
    :func:`make_cnn_runner` otherwise; ``anchored`` serves a model trained
    on the anchor-rotated target (:func:`make_cnn_phase_inpaint_fn`).  The
    reference shipped no phase-mode ``.pt``, and none is read."""
    if cfg.model.cnn_blstm.in_channels != 2:
        raise ValueError("the phase-mode runner needs cfg.model.cnn_blstm.in_channels == 2")
    if checkpoint_kind(checkpoint) == "pt":
        raise ValueError("the phase-mode CNN has no reference .pt checkpoint; use an .npz or a "
                         "checkpoint directory")
    model = load_cnn_model(cfg, checkpoint, device)
    fn = make_cnn_phase_inpaint_fn(cfg, model, anchored=anchored)
    runner = _runner(fn, device)
    runner.inpaint_fn = fn
    runner.model = model
    runner.cfg = cfg
    return runner

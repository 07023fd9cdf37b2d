"""Serving runners for an exported ``.npz`` checkpoint: the GAN and the
CNN+BiLSTM (port of ``ml_audio_inpainting_tpu/cli/inpaint.py::_build_runner``,
with the GAN's gap-only PCM16 transport of ``bench.py``'s canonical line).
The command-line runner over audio files, ``cli/inpaint.py::_build_runner``,
builds on these."""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Union

import torch

from ml_audio_inpainting_torch.models.build import build_generator, build_model
from ml_audio_inpainting_torch.runtime.inference import make_cnn_inpaint_fn, make_gan_inpaint_fn
from ml_audio_inpainting_torch.runtime.transport import make_gap_transport_fn
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.utils.precision import full_f32_convolutions
from ml_audio_inpainting_torch.weights import (
    cnn_blstm_state_dict,
    load_params_npz,
    pconv_unet_state_dict,
)

__all__ = ["make_gan_runner", "make_cnn_runner"]


def _check_npz(checkpoint) -> None:
    if not str(checkpoint).endswith(".npz"):
        raise ValueError(f"expected an exported .npz checkpoint, got {checkpoint!r}")


def make_gan_runner(
    cfg: Config,
    checkpoint: Union[str, Path],
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
    built from ``cfg`` and loads ``checkpoint`` strictly.  In f32 its
    convolutions run in full f32 (TF32 off in a scope), as the JAX reference
    on the CPU does; ``compute_dtype=torch.bfloat16`` runs the generator in
    bf16 (:func:`make_gan_inpaint_fn`).  ``phase`` is any of the four
    regimes; ``gl_iters`` counts Griffin-Lim's iterations under
    ``"griffinlim"``.  ``runner.inpaint_fn`` (the
    un-transported function), ``runner.generator`` and ``runner.cfg`` expose
    the pieces.
    """
    _check_npz(checkpoint)
    generator = build_generator(cfg, device)
    generator.load_state_dict(pconv_unet_state_dict(load_params_npz(checkpoint)))
    inpaint_fn = make_gan_inpaint_fn(cfg, generator, mode=mode, compute_dtype=compute_dtype,
                                     phase=phase, gl_iters=gl_iters)
    transport = None if transport_window is None else make_gap_transport_fn(
        inpaint_fn, transport_window)

    def runner(audio, gap_start, gap_len):
        audio = torch.as_tensor(audio, dtype=torch.float32, device=device)
        gs = torch.as_tensor(gap_start, dtype=torch.int64, device=device)
        gl = torch.as_tensor(gap_len, dtype=torch.int64, device=device)
        with full_f32_convolutions():  # bf16 convolutions are not affected
            if transport is None:
                return inpaint_fn(audio, gs, gl)[0]
            return transport(audio, gs, gl)

    runner.inpaint_fn = inpaint_fn
    runner.generator = generator
    runner.cfg = cfg
    return runner


def make_cnn_runner(
    cfg: Config,
    checkpoint: Union[str, Path],
    device="cuda",
    phase: str = "oracle",
    gl_iters: int = 64,
) -> Callable:
    """``runner(audio, gap_start, gap_len) -> restored`` on ``device``.

    ``audio`` is ``(B, S)`` f32 waveforms and ``gap_start``/``gap_len`` are
    ``(B,)`` sample counts, as numpy arrays or tensors; ``restored`` is a
    ``(B, S)`` tensor on ``device``.  The model is built from ``cfg`` and
    loads ``checkpoint`` strictly, so a config that does not match the
    weights raises.  The convolutions run in full f32 (TF32 off in a
    scope), as the JAX reference on the CPU does.  ``phase`` and
    ``gl_iters`` as for :func:`make_gan_runner`.  ``runner.inpaint_fn``,
    ``runner.model`` and ``runner.cfg`` expose the pieces.
    """
    _check_npz(checkpoint)
    model = build_model(cfg, device)
    model.load_state_dict(cnn_blstm_state_dict(load_params_npz(checkpoint)))
    fn = make_cnn_inpaint_fn(cfg, model, phase=phase, gl_iters=gl_iters)

    def runner(audio, gap_start, gap_len) -> torch.Tensor:
        audio = torch.as_tensor(audio, dtype=torch.float32, device=device)
        gs = torch.as_tensor(gap_start, dtype=torch.int64, device=device)
        gl = torch.as_tensor(gap_len, dtype=torch.int64, device=device)
        with full_f32_convolutions():
            restored, _ = fn(audio, gs, gl)
        return restored

    runner.inpaint_fn = fn
    runner.model = model
    runner.cfg = cfg
    return runner

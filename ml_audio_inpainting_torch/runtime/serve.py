"""CNN+BiLSTM serving runner (port of the CNN branch of
``ml_audio_inpainting_tpu/cli/inpaint.py::_build_runner`` for an exported
``.npz`` checkpoint).  Audio file I/O waits for a later slice of the port."""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Union

import torch

from ml_audio_inpainting_torch.models.build import build_model
from ml_audio_inpainting_torch.runtime.inference import make_cnn_inpaint_fn
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.weights import cnn_blstm_state_dict, load_params_npz

__all__ = ["make_cnn_runner"]


def make_cnn_runner(
    cfg: Config,
    checkpoint: Union[str, Path],
    device="cuda",
    phase: str = "oracle",
) -> Callable:
    """``runner(audio, gap_start, gap_len) -> restored`` on ``device``.

    ``audio`` is ``(B, S)`` f32 waveforms and ``gap_start``/``gap_len`` are
    ``(B,)`` sample counts, as numpy arrays or tensors; ``restored`` is a
    ``(B, S)`` tensor on ``device``.  The model is built from ``cfg`` and
    loads ``checkpoint`` strictly, so a config that does not match the
    weights raises.  ``runner.inpaint_fn`` and ``runner.cfg`` expose the
    pieces.
    """
    if not str(checkpoint).endswith(".npz"):
        raise ValueError(f"expected an exported .npz checkpoint, got {checkpoint!r}")
    model = build_model(cfg, device)
    model.load_state_dict(cnn_blstm_state_dict(load_params_npz(checkpoint)))
    fn = make_cnn_inpaint_fn(cfg, model, phase=phase)

    def runner(audio, gap_start, gap_len) -> torch.Tensor:
        audio = torch.as_tensor(audio, dtype=torch.float32, device=device)
        gs = torch.as_tensor(gap_start, dtype=torch.int64, device=device)
        gl = torch.as_tensor(gap_len, dtype=torch.int64, device=device)
        restored, _ = fn(audio, gs, gl)
        return restored

    runner.inpaint_fn = fn
    runner.cfg = cfg
    return runner

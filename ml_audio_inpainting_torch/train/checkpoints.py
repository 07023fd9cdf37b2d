"""Weight export of the port (port of
``ml_audio_inpainting_tpu/train/checkpoints.py::export_params_npz``).

The file is the JAX package's flat ``.npz``: ``/``-joined flax keys
(``params/...`` and ``batch_stats/...``) in flax layouts, f16 by default, so
``ml_audio_inpainting_tpu.train.checkpoints.load_params_npz`` and the port's
``weights.load_params_npz`` both read it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Optional, Union

import numpy as np
import torch

from ml_audio_inpainting_torch.models.cnn_blstm import StackedBLSTMCNN
from ml_audio_inpainting_torch.models.pconv_unet import PConvUNet
from ml_audio_inpainting_torch.weights import cnn_blstm_flat_variables, pconv_unet_flat_variables

__all__ = ["export_params_npz"]

_FLATTENERS = ((StackedBLSTMCNN, cnn_blstm_flat_variables), (PConvUNet, pconv_unet_flat_variables))


def export_params_npz(
    path: Union[str, Path],
    model: torch.nn.Module,
    dtype: Optional[str] = "float16",
    params: Optional[Mapping[str, torch.Tensor]] = None,
) -> None:
    """Write a :class:`StackedBLSTMCNN` or a :class:`PConvUNet` generator as
    a flat ``.npz`` of flax variables; any other module is a ``TypeError``.
    ``params`` replaces parameters of ``model`` by name (e.g. the GAN
    generator's EMA parameters, written with its running statistics).  f32
    arrays are stored as ``dtype`` (f16 by default, as the committed
    checkpoints are), or kept with ``dtype=None``."""
    flatten = next((f for cls, f in _FLATTENERS if isinstance(model, cls)), None)
    if flatten is None:
        raise TypeError(f"export_params_npz writes a StackedBLSTMCNN or a PConvUNet, not a "
                        f"{type(model).__name__}")
    state = model.state_dict()
    unknown = set(params or {}) - set(state)
    if unknown:
        raise KeyError(f"params not in the model: {sorted(unknown)}")
    flat = flatten({**state, **(params or {})})
    if dtype is not None:
        flat = {k: v.astype(dtype) if v.dtype == np.float32 else v for k, v in flat.items()}
    np.savez_compressed(path, **flat)

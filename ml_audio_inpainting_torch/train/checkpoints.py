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

from ml_audio_inpainting_torch.weights import cnn_blstm_flat_variables

__all__ = ["export_params_npz"]


def export_params_npz(
    path: Union[str, Path],
    variables: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
    dtype: Optional[str] = "float16",
) -> None:
    """Write a :class:`StackedBLSTMCNN` (or its ``state_dict``) as a flat
    ``.npz`` of flax variables; f32 arrays are stored as ``dtype`` (f16 by
    default, as the committed checkpoints are), or kept with ``dtype=None``."""
    state = variables.state_dict() if isinstance(variables, torch.nn.Module) else variables
    flat = cnn_blstm_flat_variables(state)
    if dtype is not None:
        flat = {k: v.astype(dtype) if v.dtype == np.float32 else v for k, v in flat.items()}
    np.savez_compressed(path, **flat)

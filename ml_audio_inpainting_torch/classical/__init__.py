"""The classical autoregressive and sparsity solvers (port of
``ml_audio_inpainting_tpu/classical/``): Janssen iterative AR inpainting,
forward/backward LPC extrapolation, overlap-add segmentation, the SPAIN
family and learned-basis SPAIN, each over a batch of clips on one device,
in f32 or f64."""

from ml_audio_inpainting_torch.classical.arinpaint import ar_extrapolate, arinpaint
from ml_audio_inpainting_torch.classical.basisopt import (
    aspain_learned,
    hard_threshold_columns,
    optimize_basis,
    sspain_learned,
)
from ml_audio_inpainting_torch.classical.janssen import janssen, janssen_gapwise
from ml_audio_inpainting_torch.classical.ola import ola_windows, segmentation_inpaint
from ml_audio_inpainting_torch.classical.spain import (
    aspain_core,
    hard_threshold_dft,
    spain_inpaint,
    sspain_core,
)

__all__ = [
    "ar_extrapolate",
    "arinpaint",
    "aspain_learned",
    "hard_threshold_columns",
    "optimize_basis",
    "sspain_learned",
    "janssen",
    "janssen_gapwise",
    "ola_windows",
    "segmentation_inpaint",
    "aspain_core",
    "hard_threshold_dft",
    "spain_inpaint",
    "sspain_core",
]

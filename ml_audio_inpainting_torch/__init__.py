"""PyTorch/CUDA port of the audio-inpainting framework, for one NVIDIA H100.

Beside ``ml_audio_inpainting_tpu`` (the JAX reference, which this package
never imports): module names mirror the JAX package's, so each port module
sits at the same relative path as the function it is held against.

It serves the CNN+BiLSTM family -- DSP core (``ops/``), the model
(``models/``), the committed npz weights (``weights.py``) and the serving
path (``runtime/``) -- and trains it in f32 (``train/``).  The BiLSTM
recurrence runs in hand-written CUDA kernels (``csrc/lstm_fwd.cu`` forward,
``csrc/lstm_bwd.cu`` backward), built with ``nvcc`` at first CUDA use and
bound with ``ctypes`` behind one ``torch.autograd.Function``
(``ops/cuda/lstm_cell.py``).
"""

__version__ = "0.1.0"

__all__ = ["__version__"]

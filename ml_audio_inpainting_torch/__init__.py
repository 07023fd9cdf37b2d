"""PyTorch/CUDA port of the audio-inpainting framework, for one NVIDIA H100.

Beside ``ml_audio_inpainting_tpu`` (the JAX reference, which this package
never imports): module names mirror the JAX package's, so each port module
sits at the same relative path as the function it is held against.

It serves the GAN family, the JAX package's main path (the PConv U-Net in
``models/pconv_unet.py``, ``runtime/inference.py::make_gan_inpaint_fn`` and
the gap-only PCM16 transport of ``runtime/transport.py``), and the
CNN+BiLSTM family -- DSP core (``ops/``), the models (``models/``), the
committed npz weights (``weights.py``) and the serving paths
(``runtime/``) -- and trains the CNN+BiLSTM in f32 (``train/``).  The BiLSTM
recurrence runs in hand-written CUDA kernels on thread-block clusters
(``csrc/lstm_fwd.cu`` forward, ``csrc/lstm_bwd.cu`` backward), built with
``nvcc`` at first CUDA use and
bound with ``ctypes`` behind one ``torch.autograd.Function``
(``ops/cuda/lstm_cell.py``).  Audio files go in and out through its own native
codec (``native/audioio.cpp``, ``data/audio_io.py``), and the ``inpaint``
and ``evaluate`` CLIs (``cli/``) serve and score both families with the
quality metrics of ``train/metrics.py``, ``train/auditory.py`` and
``train/peaq.py``.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]

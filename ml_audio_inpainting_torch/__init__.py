"""PyTorch/CUDA port of the audio-inpainting framework, for one NVIDIA H100.

Beside ``ml_audio_inpainting_tpu`` (the JAX reference, which this package
never imports): module names mirror the JAX package's, so each port module
sits at the same relative path as the function it is held against.

Serving: the GAN family, the JAX package's main path (the PConv U-Net in
``models/pconv_unet.py``, ``runtime/inference.py::make_gan_inpaint_fn`` and
the gap-only PCM16 transport of ``runtime/transport.py``), f32 and bf16;
the CNN+BiLSTM family; both without the phase oracle (``extrapolate``,
``griffinlim``), by mask, as a shift ensemble and long-form
(``runtime/longform.py``); the learned gap refiner over the GAN and the AR
fill (``models/refiner.py``, ``runtime/serve.py``) with per-clip test-time
adaptation (``runtime/adapt.py``) and the waveform solvers of
``ops/refine.py``; and the classical solvers (``classical/``: AR
extrapolation, Janssen, OLA segmentation, SPAIN and learned-basis SPAIN,
the tuned presets).

Training (``train/``): the CNN+BiLSTM in f32 and at the production bf16
recipe, the GAN at its fastest recipe (bf16, VGG19 losses, the spectral-norm
PatchGAN, EMA), the refiner head, and the training CLI with checkpoints,
resume, probes and the best weights' export (``cli/train.py``).

The BiLSTM recurrence runs in hand-written CUDA kernels on thread-block
clusters (``csrc/lstm_fwd.cu`` forward, ``csrc/lstm_bwd.cu`` backward, f32
and bf16), built with ``nvcc`` at first CUDA use and bound with ``ctypes``
behind one ``torch.autograd.Function`` (``ops/cuda/lstm_cell.py``).  Audio
files go in and out through its own native codec (``native/audioio.cpp``,
``data/audio_io.py``).  The CLIs (``cli/``): ``inpaint`` and ``evaluate``
(with ``--golden``) serve and score every family with the metrics of
``train/metrics.py``, ``train/auditory.py`` and ``train/peaq.py``;
``preprocess`` and ``build_gaps_table`` gap a corpus and write gap tables;
``ar_benchmark``, ``ar_tune`` and the host-only ``ar_plots`` sweep, tune
and plot the classical solvers; ``train``, ``train_refiner`` and ``soup``
(host only) train and average weights.  ``utils/tb_analysis.py`` reads and
plots TensorBoard scalars on the host.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]

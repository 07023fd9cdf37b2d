"""The benchmark of the PyTorch and CUDA port (``ml_audio_inpainting_torch``):
run it as ``python3 -m benchmark.run`` from the root of a checkout."""

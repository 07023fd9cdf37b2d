"""CNN+BiLSTM training (port of ``ml_audio_inpainting_tpu/train/``)."""

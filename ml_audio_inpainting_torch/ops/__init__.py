"""Tensor ops of the port: gap masks, STFT/iSTFT, normalisation, PCM16, BiLSTM."""

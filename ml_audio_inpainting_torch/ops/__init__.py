"""Tensor ops of the port: gap masks, STFT/iSTFT, normalisation, BiLSTM."""

"""Model families of the port (CNN+BiLSTM in this slice)."""

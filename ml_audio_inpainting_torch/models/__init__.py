"""Model families of the port: CNN+BiLSTM and the PConv U-Net generator."""

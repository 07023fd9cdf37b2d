"""The plain references: plain PyTorch, importing nothing of the program."""

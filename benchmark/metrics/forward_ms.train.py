"""Device milliseconds a step in the program's `train.forward` span: the
parameters' casts, the forward pass and the loss."""

from benchmark import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, "train", ("train.forward",))

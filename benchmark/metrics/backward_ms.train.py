"""Device milliseconds a step in the program's `train.backward` span: the
backward pass."""

from benchmark import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, "train", ("train.backward",))

"""Device milliseconds a step in the program's `train.features` span: the
gaps, the STFTs and the log magnitudes of the batch."""

from benchmark import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, "train", ("train.features",))

"""Device milliseconds a step in the program's `train.optimizer` spans: the
gradients' reset and sum, Adam, the schedule and the EMA."""

from benchmark import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, "train", ("train.optimizer",))

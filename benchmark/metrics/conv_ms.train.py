"""Device milliseconds a step of the convolution kernels and cuDNN's
layout transposes around them, in the traced stretch."""

from benchmark import readers

KINDS = ("convolution", "layout_transpose")


def read(ctx):
    return readers.kind_ms_per_unit(ctx, "train", KINDS)

"""Device milliseconds a request of PyTorch's elementwise kernels and
BatchNorm's, in the traced stretch."""

from benchmark import readers

KINDS = ("elementwise", "batchnorm")


def read(ctx):
    return readers.kind_ms_per_unit(ctx, "serve", KINDS)

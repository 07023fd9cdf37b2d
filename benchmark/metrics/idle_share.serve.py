"""Percent of the traced stretch, from its first kernel's start to its last
one's end, in which no kernel ran on the device."""

from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx, "serve")

"""The window's request rate times the FLOPs of one request of the plain
reference at the cell's shapes (counted on the meta device), over the peak
of the cell's element type: percent of the chip's peak."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx, "serve")

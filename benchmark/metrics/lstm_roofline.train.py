"""The LSTM kernels' share of their roofline in the traced stretch: the
least time of every LSTM call (its bytes at the HBM rate or its FLOPs at
the peak of its element type, whichever is longer; yardstick.py) over the
device time of the kernels listed here by name."""

import re

from benchmark import readers

FORWARD = re.compile(r"lstm_fwd")
BACKWARD = re.compile(r"lstm_bwd")
ALL = re.compile(r"lstm_(fwd|bwd|dwhh)")


def read(ctx):
    return readers.lstm_roofline(ctx, "train", FORWARD, BACKWARD, ALL)

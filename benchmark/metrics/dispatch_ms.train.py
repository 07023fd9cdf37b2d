"""Host milliseconds inside the program's train step call a step, the
mean over the window, from the benchmark's span around the call."""

from benchmark import readers


def read(ctx):
    return readers.dispatch_ms(ctx, "train")

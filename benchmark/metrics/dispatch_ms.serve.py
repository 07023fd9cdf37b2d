"""Host milliseconds inside the program's runner call a request, the
mean over the window, from the benchmark's span around the call."""

from benchmark import readers


def read(ctx):
    return readers.dispatch_ms(ctx, "serve")

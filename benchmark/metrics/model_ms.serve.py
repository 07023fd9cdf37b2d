"""Device milliseconds a request in the program's `serve.model` spans: the
model's input features, the network with its casts, and its output composited
into the magnitude."""

from benchmark import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, "serve", ("serve.model",))

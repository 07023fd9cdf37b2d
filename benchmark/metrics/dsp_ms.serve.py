"""Device milliseconds a request in the program's DSP spans: `serve.stft`,
`serve.phase`, `serve.istft` and `serve.transport`."""

from benchmark import program_spans

SPANS = ("serve.stft", "serve.phase", "serve.istft", "serve.transport")


def read(ctx):
    return program_spans.device_ms(ctx, "serve", SPANS)

"""STFTs a request: the change of the program's `stft` counter over each
`serve.request` span."""

from benchmark import program_spans


def read(ctx):
    return program_spans.counted(ctx, "serve", "stft")

"""Synchronising calls a request: the program's `host_syncs` count over each
`serve.request` span (the sync debug mode set to warn inside it)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.counted(ctx, "serve", "host_syncs")

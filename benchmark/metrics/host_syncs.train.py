"""Synchronising calls a step: the program's `host_syncs` count over each
`train.step` span (the sync debug mode set to warn inside it)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.counted(ctx, "train", "host_syncs")

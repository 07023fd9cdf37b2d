"""Host milliseconds a step in the program's `feed.next` spans, under the
profiler: the device feed's index, its copy and the gather's launch (the
benchmark calls the feed outside its dispatch span)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.host_ms(ctx, "train", ("feed.next",))

"""The stages of the program's root spans, and which operators of a profiled
request or step run outside them (``tests/test_torch_profiling.py`` on the
CPU's operators, ``tests/test_torch_gpu.py`` on the kernels' launches)."""

# The stages of each root span.
STAGES = {
    "serve.request": ("serve.stft", "serve.model", "serve.phase", "serve.istft",
                      "serve.transport"),
    "train.step": ("train.features", "train.forward", "train.backward", "train.optimizer"),
}


def outside_stages(events, root, works):
    """The names of the ops of ``events`` (``prof.events()``) that ``works``
    picks and that run under a ``root`` span, in none of its stages, after
    its first stage opened.  A stage's device time ends at the next stage's
    opening, so such an op's work would be charged to the stage before it,
    and the stages would still add up to the root.  Before the first stage
    is the root's own prologue (the gap masks), charged to no stage."""
    events = list(events)
    stages = STAGES[root]
    first = {}
    for e in events:
        parent = e.cpu_parent
        if e.name in stages and parent is not None and parent.name == root:
            first[id(parent)] = min(first.get(id(parent), e.time_range.start),
                                    e.time_range.start)
    found = []
    for e in events:
        if not works(e):
            continue
        up = e
        while up is not None and up.name != root and up.name not in stages:
            up = up.cpu_parent
        if up is not None and up.name == root and \
                e.time_range.start >= first.get(id(up), float("-inf")):
            found.append(e.name)
    return found

"""Training steps back to back, fed from seeded clips held on the device
through the program's device feed (``data/pipeline.py::device_corpus_feed``)
with gap layouts drawn from the seed, at most two steps in flight (the host
waits for step k - 2 before it hands over step k + 1), the loss fetched only
at the end.

Set-up builds the program's training state from the benchmark's weights and
drives it through ``setup_steps`` steps with the window's own call and
feed; the first ``reference_steps`` are the ones compared.  End to end:
``train_audio_rate``, the clips x their seconds of every step of the window
over the window's seconds (the window ends when the device has finished
its last step); ``setup_s``, the process's age when the window opens.

The comparison that decides ``correct`` (after the window, the traced
stretch and the reading of the device's peak, with the program's state
freed): the plain reference, in f32, follows the compared steps from the
same weights, on clips that the benchmark gathers itself from its corpus
by the feed's stated order, and on the same gaps.  Numbers:

* ``feed_mismatch``: the rows of the batches the feed handed to the
  program's step, in set-up and in the first step after the window (epochs
  later), that differ from the benchmark's own gather (exact);
* ``loss_gap``: each step's loss against the reference's, relative;
* ``grad_gap``: each leaf's first gradient as the optimizer got it (its
  first moment after step 1 over ``1 - beta1``): the gap between the two
  norms over the larger of the reference leaf's norm and the median leaf's,
  the worst leaf;
* ``grad_diff_leaf``: each leaf's first-gradient difference, its norm
  relative to the reference leaf's, the median leaf (norm gaps hardly see
  a loss of precision, whose errors are random per element; a difference
  does);
* ``update_gap``: each leaf's change after the compared steps, as
  ``grad_gap``; ``update_diff``: the norm of the difference of the changes
  over all leaves, relative to the reference's change (a step of the wrong
  sign reads 2, one left out 1).  The changes count only the leaves whose
  reference gradient is at least a thousandth of the median leaf's (a leaf
  with none moves under Adam by round-off alone).
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from benchmark import measure, traffic

NUMBERS = ("feed_mismatch", "loss_gap", "grad_gap", "grad_diff_leaf", "update_gap",
           "update_diff")


def run(cell, family, seed: int, seconds: float, trace: bool, device) -> measure.Outcome:
    mix = cell.mix
    is_cuda = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tr = family.trainer(cell, gen, device)
    feed, clips = _feed(tr, gen, seed, mix, device)
    spans = measure.Spans()
    fed_rows = []

    def step(k):
        audio, layout = feed(k)
        with spans.span("dispatch"), torch.profiler.record_function("bench.dispatch"):
            loss = tr.step(audio, *layout)
        return loss, audio, layout

    compared = []
    for k in range(mix["setup_steps"]):
        loss, audio, layout = step(k)
        mine = clips(k)
        fed_rows.append(_mismatch(audio, mine))
        if k < mix["reference_steps"]:
            compared.append((loss.detach().clone(), mine, [g.clone() for g in layout]))
        if k == 0:
            first = tr.first_gradients()
        if k == mix["reference_steps"] - 1:
            after = tr.snapshot()
    if is_cuda:
        torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    spans.seconds.clear()

    def loop(k0, count, deadline):
        flight, k, loss = deque(), k0, None
        while (count is None or k < k0 + count) and (deadline is None or time.perf_counter() < deadline):
            loss = step(k)[0]
            k += 1
            if is_cuda:
                done = torch.cuda.Event()
                done.record()
                flight.append(done)
                if len(flight) > 2:
                    with torch.profiler.record_function("bench.wait"):
                        flight.popleft().synchronize()
        if is_cuda:
            torch.cuda.synchronize()
        if loss is not None:
            loss.cpu()
        return k

    setup_s = measure.process_age()
    t_open = time.perf_counter()
    k_end = loop(mix["setup_steps"], None, t_open + seconds)
    window_s = time.perf_counter() - t_open
    steps = k_end - mix["setup_steps"]
    rate = steps * tr.batch * mix["clip_seconds"] / window_s
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0

    traced = None
    if trace:
        prof = measure.profiler()
        prof.start()
        k_end = loop(k_end, mix["trace_steps"], None)
        prof.stop()
        traced = measure.read_trace(prof, mix["trace_steps"])
        del prof
    fed_rows.append(_mismatch(feed(k_end)[0], clips(k_end)))

    context = {"unit": "step", "units": steps, "window_s": window_s,
               "dispatch_ms": spans.mean_ms("dispatch"), "flops_per_unit": tr.flops,
               "dtype": tr.dtype, "peak_window_bytes": (peak - tr.resident) if is_cuda else None,
               "trace": traced, "lstm": tr.lstm}
    program = {"losses": [c[0] for c in compared], "first": first, "after": after,
               "fed_rows": int(sum(fed_rows))}
    tr.free()
    if is_cuda:
        torch.cuda.empty_cache()
    reference = tr.reference([(a, g) for _, a, g in compared])
    checks = gaps(program, reference, tr.initial, cell.settings["limits"])
    return measure.Outcome(
        end_to_end={"train_audio_rate": rate, "setup_s": setup_s}, checks=checks,
        attempted=steps, failed=0, memory_peak_bytes=max(peak, setup_peak), context=context)


def _feed(tr, gen, seed: int, mix: dict, device):
    """``(feed, clips)``.  ``feed(k) -> (audio, gap tensors)`` of step ``k``:
    the program's device feed over a seeded corpus of ``corpus_clips`` clips
    (shuffled by epoch from the seed), and ``gap_layouts`` layouts drawn
    before the first step (step ``k`` takes layout ``k`` modulo their
    count).  ``clips(k)``: the clips of step ``k`` as the benchmark gathers
    them itself, by the feed's stated order (epoch ``e`` takes ``range(n)``
    shuffled by ``numpy.random.default_rng(seed + e)`` and drops the last
    short batch)."""
    from ml_audio_inpainting_torch.data.pipeline import device_corpus_feed

    n, b = mix["corpus_clips"], tr.batch
    corpus = traffic.speech_clips(gen, n, tr.samples, tr.sample_rate)
    host = corpus.cpu().numpy()
    del corpus
    batches = device_corpus_feed(host, b, shuffle=True, seed=seed, device=device, workers=1)
    layouts = traffic.train_gaps(gen, (mix["gap_layouts"], *tr.gap_shape), tr.n_gaps,
                                 tr.samples, tr.sample_rate, mix["gap_ms_min"], tr.gap_ms_max)
    tr.resident = sum(x.numel() * x.element_size() for x in layouts)

    def feed(k):
        j = k % mix["gap_layouts"]
        return next(batches), [layouts[0][j], layouts[1][j]]

    def clips(k):
        epoch, j = divmod(k, n // b)
        order = np.arange(n)
        np.random.default_rng(seed + epoch).shuffle(order)
        return torch.from_numpy(host[order[j * b:(j + 1) * b]]).to(device)

    return feed, clips


def _mismatch(fed: torch.Tensor, mine: torch.Tensor) -> torch.Tensor:
    """The rows of ``fed`` that differ from ``mine``, on the device."""
    return (fed != mine).any(dim=1).sum()


def _norms(tree: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def _leaf_gaps(program: dict, reference: dict, keep=None) -> dict:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of the reference leaf's norm and the median leaf's."""
    names = [k for k in reference if keep is None or k in keep]
    if not names:
        return {}
    median = float(np.median([reference[k] for k in names]))
    return {k: abs(program[k] - reference[k]) / max(reference[k], median, 1e-30) for k in names}


def _diffs(program: dict, reference: dict, names) -> tuple:
    """The norm of the difference over the norm of the reference, over all
    of ``names`` together and leaf by leaf."""
    d = {k: float((program[k].double() - reference[k].double()).pow(2).sum()) for k in names}
    r = {k: float(reference[k].double().pow(2).sum()) for k in names}
    whole = (sum(d.values()) / max(sum(r.values()), 1e-300)) ** 0.5
    return whole, {k: (d[k] / max(r[k], 1e-300)) ** 0.5 for k in names}


def _worst(leaf_gaps: dict):
    return max(leaf_gaps.items(), key=lambda kv: kv[1], default=("", 0.0))


def _median(leaf_values: dict):
    names = sorted(leaf_values, key=leaf_values.get)
    return (names[len(names) // 2], leaf_values[names[len(names) // 2]]) if names else ("", 0.0)


def gaps(program: dict, reference: dict, initial: dict, limits: dict) -> list:
    """The numbers of the module docstring, each the cell gives a limit, and
    ``feed_mismatch`` (exact)."""
    pairs = [(float(p), float(r)) for ps, rs in zip(program["losses"], reference["losses"])
             for p, r in zip(torch.as_tensor(ps).flatten(), torch.as_tensor(rs).flatten())]
    g_ref = _norms(reference["first"])
    median_g = float(np.median(list(g_ref.values())))
    moving = [k for k, v in g_ref.items() if v >= 1e-3 * median_g]
    grad_leaves = _diffs(program["first"], reference["first"], list(g_ref))[1]
    d_ref = {k: reference["after"][k] - initial[k] for k in moving}
    d_prog = {k: program["after"][k] - initial[k] for k in moving}
    update_whole = _diffs(d_prog, d_ref, moving)[0]
    found = {
        "feed_mismatch": ("", float(program.get("fed_rows", 0))),
        "loss_gap": ("", max(abs(p - r) / max(abs(r), 1e-30) for p, r in pairs)),
        "grad_gap": _worst(_leaf_gaps(_norms(program["first"]), g_ref)),
        "grad_diff_leaf": _median(grad_leaves),
        "update_gap": _worst(_leaf_gaps(_norms(d_prog), _norms(d_ref))),
        "update_diff": ("", update_whole),
    }
    limits = {**limits, "feed_mismatch": 0.0}
    return [measure.Check(n, found[n][1], limits[n], found[n][0]) for n in NUMBERS if n in limits]


def readings(cell, family, seed: int, device, faults=()) -> dict:
    """The numbers compared for seed ``seed``, of the program's compared
    steps (the lower readings), of the cell's lower-precision control put in
    its place (the upper readings), and of each of ``faults`` planted in the
    reference put in the program's place ("half_batch": half of each batch
    left out, the loss's sum taken over the rest; "unchanged": a step that
    leaves the state as it was)."""
    mix = cell.mix
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tr = family.trainer(cell, gen, device)
    feed, clips = _feed(tr, gen, seed, mix, device)
    batches, losses, fed_rows = [], [], []
    for k in range(mix["reference_steps"]):
        audio, gaps_k = feed(k)
        losses.append(tr.step(audio, *gaps_k).detach().clone())
        batches.append((clips(k), [g.clone() for g in gaps_k]))
        fed_rows.append(_mismatch(audio, batches[-1][0]))
        if k == 0:
            first = tr.first_gradients()
    program = {"losses": losses, "first": first, "after": tr.snapshot(),
               "fed_rows": int(sum(fed_rows))}
    tr.free()
    limits = dict.fromkeys(NUMBERS[1:], float("inf"))
    reference = tr.reference(batches)
    runs = {"program": program, "control": tr.reference(batches, control=cell.settings["control"])}
    if "half_batch" in faults:
        runs["fault_half_batch"] = tr.reference(batches, half=True)
    if "unchanged" in faults:
        runs["fault_unchanged"] = {**reference, "after": dict(tr.initial)}
    out = {k: gaps(v, reference, tr.initial, limits) for k, v in runs.items()}
    return {**{k: {c.name: c.value for c in v} for k, v in out.items()},
            "worst_leaf": {k: {c.name: c.where for c in v} for k, v in out.items()}}

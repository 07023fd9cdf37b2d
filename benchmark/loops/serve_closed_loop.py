"""Serving in a closed loop with a fixed number of requests in flight
(``bench.py``'s production loop): the runner is called for request n + 1
before request n's answer is waited for.

Each request is ``batch`` fresh clips with one gap each, all made on the
device before the window (``pool_requests`` of them; a faster program
cycles through them again, which costs the same since nothing is cached).
A request's answer is the runner's ``(patch, start)``, copied to pinned
host memory right after its dispatch, on the same stream, and waited for by
an event: it has reached the host when the event has.

End to end: ``serve_audio_rate``, the seconds of audio in the requests
whose answer reached the host inside the window over the window's seconds;
``serve_p95_ms``, the 95th percentile of the time from handing a request to
the runner to its answer on the host, over every request handed over in
the window; ``setup_s``, the process's age when the window opens.

After the window (and the traced stretch, with ``--trace 1``) the device's
peak is read, the runner is freed, and the plain reference serves a sample
of the window's requests drawn from the seed: every patch sample and start
is compared.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from benchmark import measure, traffic
from benchmark.reference import quant


def _fetch_slot(patch_shape, device):
    pin = torch.device(device).type == "cuda"
    return (torch.empty(patch_shape, dtype=torch.int16, pin_memory=pin),
            torch.empty(patch_shape[:1], dtype=torch.int32, pin_memory=pin))


def run(cell, family, seed: int, seconds: float, trace: bool, device) -> measure.Outcome:
    mix = cell.mix
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    srv = family.server(cell, gen, device)
    batch, window, depth = mix["batch"], mix["patch_window"], mix["in_flight"]
    pool = mix["pool_requests"]
    clips = traffic.speech_clips(gen, pool * batch, srv.samples, srv.sample_rate).view(
        pool, batch, srv.samples)
    starts, lengths = traffic.serve_gaps(gen, (pool, batch), srv.samples, srv.sample_rate,
                                         tuple(mix["gap_ms"]), window)
    slots = [_fetch_slot((batch, window), device) for _ in range(depth + 1)]
    spans = measure.Spans()
    is_cuda = torch.device(device).type == "cuda"

    def submit(i, slot):
        k = i % pool
        t0 = time.perf_counter()
        with spans.span("dispatch"), torch.profiler.record_function("bench.dispatch"):
            patch, start = srv.runner(clips[k], starts[k], lengths[k])
            host_patch, host_start = slots[slot]
            host_patch.copy_(patch, non_blocking=is_cuda)
            host_start.copy_(start, non_blocking=is_cuda)
            done = torch.cuda.Event() if is_cuda else None
            if done is not None:
                done.record()
        return i, t0, slot, done

    def wait(item, keep):
        i, t0, slot, done = item
        with torch.profiler.record_function("bench.wait"):
            if done is not None:
                done.synchronize()
        t1 = time.perf_counter()
        if keep is not None:
            keep[i] = (slots[slot][0].numpy().copy(), slots[slot][1].numpy().copy())
        return t1 - t0, t1

    def loop(first, count, deadline, keep, latencies, done_at):
        """Requests ``first``... until ``count`` are handed over or the
        clock passes ``deadline``; then the rest in flight are waited for."""
        flight, i = deque(), first
        while (count is None or i < first + count) and (deadline is None or time.perf_counter() < deadline):
            flight.append(submit(i, i % len(slots)))
            i += 1
            if len(flight) >= depth:
                lat, t1 = wait(flight.popleft(), keep)
                latencies.append(lat)
                done_at.append(t1)
        while flight:
            lat, t1 = wait(flight.popleft(), keep)
            latencies.append(lat)
            done_at.append(t1)
        return i

    loop(0, mix["warmup_requests"], None, None, [], [])
    setup_peak = 0
    if is_cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    spans.seconds.clear()
    resident = clips.numel() * clips.element_size()
    setup_s = measure.process_age()
    kept, latencies, done_at = {}, [], []
    t_open = time.perf_counter()
    deadline = t_open + seconds
    n = loop(0, None, deadline, kept, latencies, done_at)
    in_window = sum(1 for t in done_at if t <= deadline)
    rate = in_window * batch * mix["clip_seconds"] / seconds
    p95 = 1e3 * float(np.percentile(latencies, 95))
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0

    traced = None
    if trace:
        prof = measure.profiler()
        prof.start()
        loop(n, mix["trace_requests"], None, None, [], [])
        if is_cuda:
            torch.cuda.synchronize()
        prof.stop()
        traced = measure.read_trace(prof, mix["trace_requests"])
        del prof

    context = {"unit": "request", "units": in_window, "window_s": seconds,
               "dispatch_ms": spans.mean_ms("dispatch"), "flops_per_unit": srv.flops,
               "dtype": srv.dtype, "peak_window_bytes": peak - resident if is_cuda else None,
               "trace": traced, "lstm": getattr(srv, "lstm", None)}
    picks = sample(seed, sorted(kept), mix["check_requests"])
    srv.runner = None  # the program's state is freed before the reference runs
    if is_cuda:
        torch.cuda.empty_cache()
    checks = gaps(kept, reference_answers(srv, clips, starts, lengths, picks),
                  cell.settings["limits"])
    return measure.Outcome(
        end_to_end={"serve_audio_rate": rate, "serve_p95_ms": p95, "setup_s": setup_s},
        checks=checks, attempted=n, failed=n - len(kept),
        memory_peak_bytes=max(peak, setup_peak), context=context)


def sample(seed: int, done: list, k: int) -> list:
    """``k`` of the requests answered (the last one always among them),
    drawn from the seed."""
    rng = np.random.default_rng(seed)
    rest = [i for i in done if i != done[-1]]
    picks = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return sorted([rest[j] for j in picks] + [done[-1]])


def reference_answers(srv, clips, starts, lengths, picks, control: str = None) -> dict:
    """``{i: (patch, start, in_gap)}`` of the plain reference for the
    requests ``picks``, in f32, or as the lower-precision ``control`` of
    :data:`quant.CONTROLS`; ``in_gap`` marks the patch samples inside the
    gap."""
    q, scope, _ = quant.CONTROLS[control] if control else (quant.identity, quant.full_f32, None)
    pool = clips.shape[0]
    out = {}
    with scope(), torch.no_grad():
        for i in picks:
            k = i % pool
            patch, start = srv.reference(clips[k], starts[k], lengths[k], q)
            pos = start[:, None] + torch.arange(patch.shape[1], device=start.device)
            in_gap = (pos >= starts[k][:, None]) & (pos < (starts[k] + lengths[k])[:, None])
            out[i] = (patch.cpu().numpy(), start.cpu().numpy(), in_gap.cpu().numpy())
    return out


def gaps(answers: dict, reference: dict, limits: dict) -> list:
    """Of the sampled requests: the widest gap of a patch sample in PCM16
    steps (``patch_gap_lsb``); over the samples inside the gaps, the percent
    whose PCM16 value differs (``patch_flip_share``) and the root mean square
    of the gaps over that of the reference's samples, in percent
    (``patch_rms_gap``); and the count of starts that differ
    (``start_mismatch``, exact).  Each number the cell gives a limit is
    compared; the start always is."""
    widest, flips, inside, wrong_start, sq_gap, sq_ref = 0, 0, 0, 0, 0.0, 0.0
    for i, (ref_patch, ref_start, in_gap) in reference.items():
        patch, start = answers[i][:2]
        gap = np.abs(patch.astype(np.int64) - ref_patch.astype(np.int64))
        widest = max(widest, int(gap.max()))
        flips += int((gap[in_gap] > 0).sum())
        inside += int(in_gap.sum())
        sq_gap += float((gap[in_gap].astype(np.float64) ** 2).sum())
        sq_ref += float((ref_patch[in_gap].astype(np.float64) ** 2).sum())
        wrong_start += int((start.astype(np.int64) != ref_start.astype(np.int64)).sum())
    values = {"patch_gap_lsb": float(widest), "patch_flip_share": 100.0 * flips / max(inside, 1),
              "patch_rms_gap": 100.0 * (sq_gap / max(sq_ref, 1.0)) ** 0.5}
    return [measure.Check(name, values[name], limits[name]) for name in values if name in limits] + [
        measure.Check("start_mismatch", float(wrong_start), 0.0)]


def readings(cell, family, seed: int, device, faults=()) -> dict:
    """The numbers compared for seed ``seed`` on ``check_requests`` requests
    served one at a time, of the program (the lower readings) and of the
    cell's lower-precision control put in its place (the upper readings),
    each against the f32 reference; and of each of ``faults`` ("answer": one
    sample of one patch altered where it is produced, by flipping bit 12 of
    its PCM16 value, 4096 steps)."""
    mix = cell.mix
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    srv = family.server(cell, gen, device)
    k, batch = mix["check_requests"], mix["batch"]
    clips = traffic.speech_clips(gen, k * batch, srv.samples, srv.sample_rate).view(
        k, batch, srv.samples)
    starts, lengths = traffic.serve_gaps(gen, (k, batch), srv.samples, srv.sample_rate,
                                         tuple(mix["gap_ms"]), mix["patch_window"])
    program = {}
    for i in range(k):
        patch, start = srv.runner(clips[i], starts[i], lengths[i])
        program[i] = (patch.cpu().numpy(), start.cpu().numpy())
    srv.runner = None
    picks = list(range(k))
    reference = reference_answers(srv, clips, starts, lengths, picks)
    control = reference_answers(srv, clips, starts, lengths, picks, cell.settings["control"])
    limits = dict.fromkeys(("patch_gap_lsb", "patch_flip_share", "patch_rms_gap"), float("inf"))
    out = {"program": {c.name: c.value for c in gaps(program, reference, limits)},
           "control": {c.name: c.value for c in gaps(control, reference, limits)}}
    if "answer" in faults:
        altered = dict(program)
        patch, start = altered[k - 1]
        patch = patch.copy()
        patch[0, patch.shape[1] // 2] ^= 0x1000
        altered[k - 1] = (patch, start)
        out["fault_answer"] = {c.name: c.value for c in gaps(altered, reference, limits)}
    return out

"""The per-layer metrics that read the program's spans and counters
(``benchmark/program_spans.py``), each after a tiny traced run of its cell
on the CPU: the counters read numbers, the device figures None (no CUDA
events on the CPU), and every reader None on a stale or foreign stretch.

On the CPU the traced stretch holds no kernel, so ``read_trace`` hands back
no ``units``; each check gives the context the count a card's trace would
carry, the mix's traced requests or steps."""

import pytest
import torch

from benchmark import spec
from benchmark.tests.tiny import tiny_cell

# Each cell's new metrics: the number it reads on the CPU, or None.
CELLS = {
    "gan_serve_bf16_b32": {"model_ms.serve": None, "dsp_ms.serve": None,
                           "stft_calls.serve": 2.0, "host_syncs.serve": 0.0},
    "cnn_blstm_serve_f32_b32": {"model_ms.serve": None, "dsp_ms.serve": None,
                                "stft_calls.serve": 1.0, "host_syncs.serve": 0.0},
    "cnn_blstm_train_bf16_b128": {"features_ms.train": None, "forward_ms.train": None,
                                  "backward_ms.train": None, "optimizer_ms.train": None,
                                  "host_syncs.train": 0.0, "feed_ms.train": "host"},
}


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _readers(names):
    return {n: spec.load_module(spec.HERE / "metrics" / f"{n}.py") for n in names}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_span_metrics_after_a_traced_run(name):
    from ml_audio_inpainting_torch.runtime import profiling

    cell = tiny_cell(name, "float32")
    declared = {m["name"] for m in cell.per_layer}
    assert set(CELLS[name]) <= declared
    outcome = spec.loop(cell).run(cell, spec.family(cell), 3, 0.3, True, "cpu")
    assert outcome.failed == 0
    units = cell.mix["trace_requests"] if outcome.context["unit"] == "request" else \
        cell.mix["trace_steps"]
    ctx = {**outcome.context, "trace": {"units": units}}
    readers = _readers(CELLS[name])
    for metric, want in CELLS[name].items():
        got = readers[metric].read(ctx)
        if want == "host":
            assert got is not None and got > 0, metric
        else:
            assert got == want, (metric, got)

    stale = [{**ctx, "trace": {"units": units + 1}}, {**ctx, "trace": None},
             {**ctx, "unit": "step" if ctx["unit"] == "request" else "request"}]
    for other in stale:
        assert all(r.read(other) is None for r in readers.values()), other
    profiling.span("idle")  # not live: the next live span starts a new stretch
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("another.root"):
            pass
    assert all(r.read(ctx) is None for r in readers.values())

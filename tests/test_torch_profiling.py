"""The program's spans and counters (``runtime/profiling.py``) on the CPU:
nothing recorded while no profiler records, nesting, units and stretches,
the counters a root span keeps, host-only spans, the spans the serving
entries and the CNN train step open, and that every op of a request or step
runs in one of its stages.  The device times, the host-sync count and the
same check on the kernels, which need a card, are
``tests/test_torch_gpu.py``'s."""

from unittest import mock

import numpy as np
import pytest
import torch

from ml_audio_inpainting_torch.ops.cuda import lstm_cell
from ml_audio_inpainting_torch.runtime import profiling
from ml_audio_inpainting_torch.runtime.serve import make_cnn_runner, make_gan_runner
from ml_audio_inpainting_torch.runtime.synthetic import gan_config, speech_like_batch
from ml_audio_inpainting_torch.runtime.transport import make_gap_transport_fn
from ml_audio_inpainting_torch.train.cnn_trainer import create_cnn_state, make_cnn_train_step
from ml_audio_inpainting_torch.utils.config import Config

from span_stages import outside_stages
from torch_threads import one_thread  # noqa: F401  (a module fixture)

NAMES = ("serve.request", "serve.stft", "train.step", "feed.next")
CLIPS = 2
SAMPLES = 16000
def _names(records):
    return [r.name for r in records]


@pytest.mark.parametrize("name", NAMES)
def test_a_span_is_idle_while_no_profiler_records(name):
    before = profiling.stretch()
    with mock.patch.object(profiling, "record_function", side_effect=AssertionError), \
            mock.patch.object(torch.cuda, "Event", side_effect=AssertionError):
        for _ in range(3):
            with profiling.span(name):
                with profiling.span("inner"):
                    profiling.count("test.idle")
    assert profiling.span(name) is profiling.span("another")  # one shared no-op
    assert _names(profiling.stretch()) == _names(before)


@pytest.mark.parametrize("start", ["context", "start_stop"])
def test_nesting_parents_and_units(start):
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    profiling.span("idle")  # the next live span starts a new stretch
    if start == "context":
        prof.__enter__()
    else:
        prof.start()
    try:
        for _ in range(2):
            with profiling.span("a"):
                with profiling.span("b"):
                    with profiling.span("c"):
                        with profiling.span("b"):  # already open: not a new span
                            pass
                with profiling.span("d"):
                    pass
        with profiling.span("e"):
            pass
    finally:
        if start == "context":
            prof.__exit__(None, None, None)
        else:
            prof.stop()
    records = profiling.stretch()
    assert [(r.name, r.parent, r.unit) for r in records] == [
        ("a", None, 0), ("b", "a", 0), ("c", "b", 0), ("d", "a", 0),
        ("a", None, 1), ("b", "a", 1), ("c", "b", 1), ("d", "a", 1), ("e", None, 2)]
    assert all(r.host_ms >= 0 and r.start_event is None and r.device_ms is None for r in records)
    a = records[0]
    assert a.host_start_ns <= records[1].host_start_ns <= records[1].host_end_ns <= a.host_end_ns
    assert {e.key for e in prof.key_averages()} >= {"a", "b", "c", "d", "e"}


@pytest.mark.parametrize("idle_between", [True, False])
def test_a_new_stretch_drops_the_old(idle_between):
    profiling.span("idle")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("first"):
            pass
    if idle_between:
        with profiling.span("not live"):
            pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("second"):
            pass
    want = ["second"] if idle_between else ["first", "second"]
    assert _names(profiling.stretch()) == want
    assert [r.unit for r in profiling.stretch()] == list(range(len(want)))


@pytest.mark.parametrize("n", [1, 3])
def test_a_root_keeps_its_counters_changes(n):
    profiling.span("idle")
    profiling.count("test.outside", 5)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("root"):
            profiling.count("test.root", n)
            with profiling.span("child"):
                profiling.count("test.child", 2 * n)
        profiling.count("test.outside")
    root, child = profiling.stretch()
    assert root.counts == {"test.root": n, "test.child": 2 * n}
    assert child.counts is None
    assert profiling.counters()["test.outside"] >= 6


class _FakeEvent:
    """A timing event whose record takes the next tick of a clock."""

    clock = [0]

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.tick = None

    def record(self):
        _FakeEvent.clock[0] += 1
        self.tick = _FakeEvent.clock[0]

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.tick - self.tick)


class _NoSyncCount:
    def __enter__(self):
        return self

    def close(self):
        return 0


class _CountedSyncWatch(_NoSyncCount):
    opened = 0

    def __enter__(self):
        _CountedSyncWatch.opened += 1
        return self


def test_a_host_only_span_records_no_event_and_watches_no_syncs():
    """``device=False`` (the feed's ``feed.next``) keeps the host times only:
    no timing event and no sync watch, and the device roots around it still
    end at their own boundaries."""
    profiling.span("idle")
    _CountedSyncWatch.opened = 0
    with mock.patch.object(torch.cuda, "is_initialized", return_value=True), \
            mock.patch.object(torch.cuda, "Event", _FakeEvent), \
            mock.patch.object(profiling, "_SyncCount", _CountedSyncWatch), \
            torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("root"):
            with profiling.span("a"):
                pass
        with profiling.span("feed.next", device=False):
            profiling.count("test.host")
        with profiling.span("root"):
            pass
    first, a, feed, second = profiling.stretch()
    assert feed.start_event is None and feed.end_event is None and feed.device_ms is None
    assert feed.host_ms >= 0 and feed.counts == {"test.host": 1}
    assert _CountedSyncWatch.opened == 2
    assert [r.device_ms for r in (first, a, second)] == [2.0, 1.0, 1.0]


@pytest.mark.parametrize("units", [1, 2])
def test_a_span_ends_at_the_next_boundary(units):
    """On CUDA a span records one event where it opens; it ends at the next
    one (the next span's, or its root's end), so a root's children tile it
    from the first child's opening to the root's end."""
    profiling.span("idle")
    with mock.patch.object(torch.cuda, "is_initialized", return_value=True), \
            mock.patch.object(torch.cuda, "Event", _FakeEvent), \
            mock.patch.object(profiling, "_SyncCount", _NoSyncCount), \
            torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(units):
            with profiling.span("root"):
                with profiling.span("a"):
                    pass
                with profiling.span("b"):
                    with profiling.span("c"):
                        pass
    records = profiling.stretch()
    assert len(records) == 4 * units
    for k in range(units):
        root, a, b, c = records[4 * k:4 * k + 4]
        assert a.end_event is b.start_event and b.start_event is not c.start_event
        assert c.end_event is b.end_event is root.end_event
        assert [r.device_ms for r in (root, a, b, c)] == [4.0, 1.0, 2.0, 1.0]
        assert a.device_ms + b.device_ms == root.device_ms - 1.0  # root's own first tick


def _gan_entry():
    cfg = gan_config()
    cfg.data.max_len_s = SAMPLES / 16000
    g = cfg.model.generator
    g.enc_layer_cfg = [(8, 7, 2), (16, 5, 2), (16, 3, 2)]
    g.dec_layer_cfg = [(16, 3, 1), (8, 3, 1)]
    g.final_interim_ch = 8
    return make_gan_runner(cfg, None, device="cpu", mode="enhanced", phase="extrapolate",
                           transport_window=2048)


def _cnn_entry():
    cfg = Config.from_dict({"data": {"max_len_s": SAMPLES / 16000},
                            "model": {"num_lstm_layers": 2, "lstm_hidden_dim": 8,
                                      "enc_filters": [4, 4], "dec_filters": [4, 4]}})
    return make_gap_transport_fn(make_cnn_runner(cfg, None, device="cpu",
                                                 phase="extrapolate").inpaint_fn, 2048)


# Each serving entry: its children in stage order and its STFTs a request.
ENTRIES = {
    "gan_runner": (_gan_entry, ["serve.stft", "serve.stft", "serve.model", "serve.phase",
                                "serve.istft", "serve.transport"], 2),
    "cnn_transport": (_cnn_entry, ["serve.stft", "serve.model", "serve.phase", "serve.istft",
                                   "serve.transport"], 1),
}


def _serve_traced(entry, requests):
    fn = ENTRIES[entry][0]()
    audio = torch.tensor(speech_like_batch(np.random.default_rng(0), CLIPS, SAMPLES / 16000))
    starts = torch.tensor([3000, 9000])
    lengths = torch.tensor([1280, 640])
    fn(audio, starts, lengths)  # warm, not live
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(requests):
            patch, start = fn(audio, starts, lengths)
    assert patch.shape == (CLIPS, 2048) and patch.dtype == torch.int16
    return profiling.stretch(), prof.events()


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_a_serving_entry_opens_one_request_span_a_request(entry):
    records, _ = _serve_traced(entry, 2)
    roots = [r for r in records if r.parent is None]
    assert _names(roots) == ["serve.request"] * 2
    for root in roots:
        children = [r for r in records if r.unit == root.unit and r is not root]
        assert _names(children) == ENTRIES[entry][1]
        assert {r.parent for r in children} == {"serve.request"}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_stft_calls_a_request(entry):
    roots = [r for r in _serve_traced(entry, 3)[0] if r.parent is None]
    assert [r.counts.get("stft") for r in roots] == [ENTRIES[entry][2]] * 3
    assert [r.counts.get("host_syncs", 0) for r in roots] == [0] * 3  # no card: not watched


def _train_traced():
    cfg = Config.from_dict({"data": {"max_len_s": 0.5},
                            "model": {"num_lstm_layers": 2, "lstm_hidden_dim": 8,
                                      "enc_filters": [4, 4], "dec_filters": [4, 4]},
                            "training": {"batch_size": CLIPS}})
    state = create_cnn_state(cfg, device="cpu")
    step = make_cnn_train_step(cfg)
    audio = torch.tensor(speech_like_batch(np.random.default_rng(1), CLIPS, 0.5))
    starts = torch.tensor([[2000], [4000]])
    step(state, audio, starts)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        state, m = step(state, audio, starts)
    assert torch.isfinite(m["loss"])
    return profiling.stretch(), prof.events()


def test_the_cnn_train_step_opens_its_four_parts():
    records, _ = _train_traced()
    assert [(r.name, r.parent) for r in records] == [
        ("train.step", None), ("train.features", "train.step"),
        ("train.optimizer", "train.step"), ("train.forward", "train.step"),
        ("train.backward", "train.step"), ("train.optimizer", "train.step")]
    assert records[0].counts.get("stft") == 2  # the clean and the gapped clip's


@pytest.mark.parametrize("unit", [*sorted(ENTRIES), "cnn_train_step"])
def test_every_op_of_a_unit_runs_in_a_stage(unit):
    """Every operator a request or step runs after its first stage opened
    runs inside one of its stages (``outside_stages``): no stage's time is
    charged with work between two stages.  The step's last op, the loss's
    ``detach``, is an alias that does no work."""
    if unit == "cnn_train_step":
        root, (records, events) = "train.step", _train_traced()
    else:
        root, (records, events) = "serve.request", _serve_traced(unit, 2)
    assert sum(r.name == root for r in records) == (1 if root == "train.step" else 2)
    works = lambda e: e.name.startswith("aten::") and e.name != "aten::detach"  # noqa: E731
    assert outside_stages(events, root, works) == []
    # Counting every op, only that alias is left outside.
    assert outside_stages(events, root, lambda e: e.name.startswith("aten::")) == (
        ["aten::detach"] if root == "train.step" else [])


@pytest.mark.parametrize("name", lstm_cell.LAUNCH_COUNTERS)
def test_kernel_launches_keep_their_keys_and_values(name):
    lstm_cell.reset_kernel_launches()
    assert lstm_cell.kernel_launches() == dict.fromkeys(
        ("lstm_fwd", "lstm_fwd_bf16", "lstm_bwd", "lstm_bwd_bf16", "lstm_dwhh",
         "lstm_dwhh_bf16"), 0)
    kernel = name.removesuffix("_bf16")
    lstm_cell._count(kernel, torch.bfloat16 if name.endswith("_bf16") else torch.float32)
    lstm_cell._count(kernel, torch.bfloat16 if name.endswith("_bf16") else torch.float32)
    assert lstm_cell.kernel_launches() == {k: 2 if k == name else 0
                                           for k in lstm_cell.LAUNCH_COUNTERS}
    assert profiling.counters()[name] == 2
    lstm_cell.reset_kernel_launches()
    assert set(lstm_cell.kernel_launches().values()) == {0}

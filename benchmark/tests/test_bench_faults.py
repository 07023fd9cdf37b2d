"""What decides ``correct``, with the timed path broken underneath: a whole
run at a tiny size on the CPU (in f32, where sound runs read far inside the
committed limits) comes out correct, and comes out not correct with each
fault the cell can have: an answer altered where it is produced (serving);
a step that leaves the state unchanged, half of each batch left out, and a
feed that hands over a stale or a zeroed batch (training).  The exchange
between chips has no fault to plant: every cell takes one chip.  Also the command's refusals: no result without a card."""

import subprocess
import sys

import pytest
import torch

from benchmark import spec
from benchmark.tests.tiny import tiny_cell

SERVE = ["gan_serve_bf16_b32", "cnn_blstm_serve_f32_b32"]
# The benchmark's training cells.
TRAIN = {"cnn_blstm_train_bf16_b128": ("cnn_trainer", "make_cnn_train_step")}


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# On the CPU, f32 products and convolutions sum in other orders than on the
# card: 0.2-0.6 % of the gap samples of a sound f32 run land on the other
# PCM16 step (0.01 % on an H100), so this number is judged on the card only.
CARD_ONLY = {"patch_flip_share"}


def _run(cell, seconds=0.3):
    return spec.loop(cell).run(cell, spec.family(cell), 5, seconds, False, "cpu")


def _failed(outcome) -> set:
    return {c.name for c in outcome.checks if not c.ok}


@pytest.mark.parametrize("name", SERVE + sorted(TRAIN))
def test_sound_run_is_correct(name):
    outcome = _run(tiny_cell(name, "float32"))
    assert outcome.failed == 0
    assert not _failed(outcome) - CARD_ONLY, outcome.checks


@pytest.mark.parametrize("name", SERVE)
def test_altered_answer_is_not_correct(name, monkeypatch):
    cell = tiny_cell(name, "float32")
    family = spec.family(cell)
    server = family.server

    def broken(*args, **kwargs):
        srv = server(*args, **kwargs)
        runner = srv.runner

        def altered(audio, gap_start, gap_len):
            patch, start = runner(audio, gap_start, gap_len)
            patch = patch.clone()
            patch[0, patch.shape[1] // 2] ^= 0x1000
            return patch, start

        srv.runner = altered
        return srv

    monkeypatch.setattr(family, "server", broken)
    outcome = _run(cell)
    assert not outcome.correct
    assert "patch_gap_lsb" in _failed(outcome)


def _states(args):
    return [a for a in args if hasattr(a, "model")]


def _unchanged(step):
    def frozen(*args):
        saved = [{k: p.detach().clone() for k, p in st.model.named_parameters()}
                 for st in _states(args)]
        out = step(*args)
        with torch.no_grad():
            for st, params in zip(_states(args), saved):
                for k, p in st.model.named_parameters():
                    p.copy_(params[k])
        return out
    return frozen


def _half(step):
    def half(*args):
        n = len(_states(args))
        audio, gaps = args[n], args[n + 1:]
        cut = audio.shape[0] // 2
        return step(*args[:n], audio[:cut], *[g[:cut] for g in gaps])
    return half


@pytest.mark.parametrize("fault", [_unchanged, _half], ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("name", sorted(TRAIN))
def test_training_fault_is_not_correct(name, fault, monkeypatch):
    import importlib

    module = importlib.import_module(f"ml_audio_inpainting_torch.train.{TRAIN[name][0]}")
    make = getattr(module, TRAIN[name][1])
    monkeypatch.setattr(module, TRAIN[name][1], lambda *a, **k: fault(make(*a, **k)))
    outcome = _run(tiny_cell(name, "float32"))
    assert not outcome.correct, outcome.checks


def _stale_feed(make):
    """The device feed handing over each batch twice."""
    def feed(*args, **kwargs):
        for batch in make(*args, **kwargs):
            yield batch
            yield batch.clone()
    return feed


def _zeroed_feed(make):
    """The device feed handing over batches of silence after its first."""
    def feed(*args, **kwargs):
        batches = make(*args, **kwargs)
        yield next(batches)
        for batch in batches:
            yield torch.zeros_like(batch)
    return feed


@pytest.mark.parametrize("fault", [_stale_feed, _zeroed_feed], ids=["stale", "zeroed"])
def test_feed_fault_is_not_correct(fault, monkeypatch):
    from ml_audio_inpainting_torch.data import pipeline

    monkeypatch.setattr(pipeline, "device_corpus_feed", fault(pipeline.device_corpus_feed))
    outcome = _run(tiny_cell("cnn_blstm_train_bf16_b128", "float32"))
    assert not outcome.correct
    assert "feed_mismatch" in _failed(outcome)


def test_no_result_without_a_card():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "gan_serve_bf16_b32",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(spec.ROOT)})
    assert out.returncode == 2
    assert not out.stdout.strip()


def test_limits_are_set_for_every_cell():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        limits = spec.load_json(spec.HERE / "cells" / f"{w['name']}.json")["limits"]
        assert limits and all(0 < v < 1e6 for v in limits.values()), (w["name"], limits)

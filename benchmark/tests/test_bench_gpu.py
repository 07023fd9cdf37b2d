"""On a card (marked ``gpu``; each test decides inside whether one is
there): one short run of every cell through the command, correct and with
the result line's keys; and each cell's lower-precision control against the
committed limits at the cell's own size, on three seeds, failing at least
one of them (the TF32 control has no CPU form).

    python3 -m pytest benchmark/tests -m gpu    # on the card's machine
"""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import spec

CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(name):
    _card()
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", name, "--seed",
                          str(2**31 + 77), "--seconds", "3", "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
    assert {m["name"] for m in spec.load_cell(name).end_to_end} == set(line["metrics"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(name)
    limits = cell.settings["limits"]
    for seed in (101, 102, 103):
        out = spec.loop(cell).readings(cell, spec.family(cell), seed, "cuda")
        assert any(out["control"][k] > v for k, v in limits.items()), out
        assert all(out["program"][k] <= v for k, v in limits.items()), out
        torch.cuda.empty_cache()

"""A later change adds a mix, a cell and a per-layer metric as new files and
new ``BENCHMARK.json`` entries, and edits no file that is there: here in a
copy of the benchmark in a temporary directory, run at a tiny size on the
CPU."""

import json
import shutil

import torch

from benchmark import run, spec
from benchmark.tests.tiny import tiny_cell

NEW_METRIC = '''"""Requests answered in the window (a test's metric)."""


def read(ctx):
    return ctx["units"] if ctx.get("unit") == "request" else None
'''


def test_cell_and_metric_from_new_files(tmp_path):
    torch.manual_seed(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    base = tmp_path / "benchmark"
    before = {p.relative_to(base): p.read_bytes() for p in base.rglob("*") if p.is_file()}
    mix = json.loads((base / "mixes" / "serve_pipelined.json").read_text())
    (base / "mixes" / "serve_pipelined_b8.json").write_text(json.dumps({**mix, "in_flight": 3}))
    (base / "cells" / "gan_serve_bf16_b8.json").write_text(
        (base / "cells" / "gan_serve_bf16_b32.json").read_text())
    (base / "metrics" / "answered.serve.py").write_text(NEW_METRIC)
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    bench["workloads"].append({"name": "gan_serve_bf16_b8", "config": "gan_pconv_unet",
                               "traffic": "serve_pipelined_b8", "chips": 1, "why": "a test"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "gan_serve_bf16_b32" in metric.get("workloads", []):
            metric["workloads"].append("gan_serve_bf16_b8")
    bench["per_layer"].append({"name": "answered.serve", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "entry: runners, transport and train steps",
                               "moves": "serve_audio_rate", "workloads": ["gan_serve_bf16_b8"]})
    cell = tiny_cell("gan_serve_bf16_b8", "float32", bench=bench, base=base)
    assert cell.mix["in_flight"] == 3
    try:
        outcome = spec.loop(cell).run(cell, spec.family(cell), 3, 5.0, True, "cpu")
    finally:
        torch.set_num_threads(threads)
    line = run.result_line(cell, outcome, True, {"platform": "cpu"})
    assert line["metrics"]["answered.serve"]["value"] == outcome.context["units"] > 0
    assert "mfu.serve" in line["metrics"]
    after = {p.relative_to(base): p.read_bytes() for p in base.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)

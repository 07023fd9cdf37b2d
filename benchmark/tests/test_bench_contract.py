"""``BENCHMARK.json`` keeps the shape the benchmark's check reads: its keys,
names, units and texts within their limits, every cell reporting
``setup_s``, another end-to-end metric and a per-layer one, every per-layer
metric moving an end-to-end metric its cells report, and every file a
cell names present under ``paths``."""

import json
import re

from benchmark import spec

BENCH_FILE = spec.ROOT / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape():
    raw = BENCH_FILE.read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == KEYS["top"]
    assert 1 <= len(b["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
                                               and not p.startswith("/") and ".." not in p
                                               for p in b["paths"])
    assert len(b["command"]) <= 32 and all(_text(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"]) and _text(c["source"])
        assert _text(c["why"]) and len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        assert (spec.ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert set(w) == KEYS["workload"] and NAME.match(w["name"]) and _text(w["why"])
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert set(m) - {"workloads"} == KEYS[kind], m
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert _text(m["layer"]) and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(set(x["name"] for x in b["workloads"])) == len(b["workloads"])
    assert len({m["name"] for m in b["end_to_end"] + b["per_layer"]}) == len(
        b["end_to_end"]) + len(b["per_layer"])
    assert names


def test_every_cell_reports_what_it_must():
    b = spec.load_json(BENCH_FILE)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in b["end_to_end"])
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"], b)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
            assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert (spec.HERE / "families" / f"{cell.config['family']}.py").is_file()
        assert (spec.HERE / "loops" / f"{cell.mix['loop']}.py").is_file()

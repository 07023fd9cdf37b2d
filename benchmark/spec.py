"""What a cell is made of, found by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each piece is a file of its own, so a later change adds a cell, a mix or a
metric by adding files and entries, and edits none:

* the configuration: the ``file`` of its ``configs`` entry (JSON, with
  ``family`` naming the adapter ``families/<family>.py`` that builds the
  program's entry points and the plain reference for it);
* the mix: ``mixes/<traffic>.json``, whose ``loop`` names the generic
  ``loops/<loop>.py`` that runs it;
* the cell's own settings (element type, recipe, the limits of the
  comparison that decides ``correct``): ``cells/<workload>.json``;
* a per-layer metric: its reader ``metrics/<metric name>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic: str
    mix: dict
    settings: dict
    chips: int
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    base: Path = HERE


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None, root: Path = ROOT,
              base: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (``root/BENCHMARK.json`` when None),
    its files read from ``base`` (this folder)."""
    bench = bench if bench is not None else load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, config_name=conf["name"], config=load_json(root / conf["file"]),
        traffic=entry["traffic"], mix=load_json(base / "mixes" / f"{entry['traffic']}.json"),
        settings=load_json(base / "cells" / f"{name}.json"), chips=entry["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)], base=base)


def program_config(config: dict, recipe: Optional[dict] = None):
    """The program's ``Config`` of a configuration file's ``data``, ``model``
    and ``training`` sections, with a cell's recipe laid over them."""
    from ml_audio_inpainting_torch.utils.config import Config

    tree = {k: dict(config[k]) for k in ("data", "model", "training")}
    for section, values in (recipe or {}).items():
        tree[section].update(values)
    return Config.from_dict(tree)


def load_module(path: Path) -> ModuleType:
    """The Python file ``path`` as a module (its name need not be an
    identifier: metric files carry dots)."""
    key = f"benchmark_file_{abs(hash(str(path)))}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def family(cell: Cell) -> ModuleType:
    return load_module(cell.base / "families" / f"{cell.config['family']}.py")


def loop(cell: Cell) -> ModuleType:
    return load_module(cell.base / "loops" / f"{cell.mix['loop']}.py")


def readers(cell: Cell) -> Dict[str, ModuleType]:
    return {m["name"]: load_module(cell.base / "metrics" / f"{m['name']}.py")
            for m in cell.per_layer}

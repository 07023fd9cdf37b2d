"""Every CPU test module of the port runs at one torch thread
(``tests/torch_threads.py::one_thread``): read from the AST of each
``tests/test_torch_*.py`` but the card's own (``test_torch_gpu.py``, run
with ``--noconftest`` on the card), and seen from inside a test."""

import ast
from pathlib import Path

import pytest
import torch

from torch_threads import one_thread  # noqa: F401  (a module fixture)

TESTS = Path(__file__).resolve().parent
ON_THE_CARD = ("test_torch_gpu.py",)


def _cpu_modules():
    return sorted(p for p in TESTS.glob("test_torch_*.py") if p.name not in ON_THE_CARD)


def _imports_one_thread(tree: ast.Module) -> bool:
    """Whether ``tree`` binds ``one_thread`` from ``torch_threads`` at module
    level (where pytest finds a module's fixtures)."""
    return any(
        isinstance(node, ast.ImportFrom) and node.module == "torch_threads" and node.level == 0
        and any(a.name == "one_thread" and a.asname is None for a in node.names)
        for node in tree.body
    )


@pytest.mark.parametrize("source,pinned", [
    ("from torch_threads import one_thread", True),
    ("import torch\nfrom torch_threads import one_thread  # noqa: F401", True),
    ("from torch_threads import one_thread as pin", False),
    ("def f():\n    from torch_threads import one_thread", False),
    ("from test_torch_refiner import one_thread", False),
    ("import torch", False),
])
def test_checker_reads_the_module_level_import(source, pinned):
    assert _imports_one_thread(ast.parse(source)) == pinned


def test_every_cpu_port_module_runs_at_one_thread():
    modules = _cpu_modules()
    assert len(modules) > 50 and Path(__file__) in modules
    missing = [p.name for p in modules if not _imports_one_thread(ast.parse(p.read_text()))]
    assert not missing, f"modules without `from torch_threads import one_thread`: {missing}"


def test_a_test_sees_one_thread():
    assert torch.get_num_threads() == 1

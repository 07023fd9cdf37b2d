"""The benchmark stands apart from JAX: no file under ``benchmark/``
imports a module whose top-level name is ``jax``, ``jaxlib``, ``flax``,
``optax`` or ``ml_audio_inpainting_tpu`` (whole names: the port's
``ml_audio_inpainting_torch`` begins with the JAX package's prefix and is
allowed), and no file of ``benchmark/reference/`` imports the program.
Checked on every file's syntax tree, and in a fresh interpreter that loads
the harness, a mix and a reference."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ml_audio_inpainting_tpu"}
PROGRAM = "ml_audio_inpainting_torch"


def _files():
    return sorted(p for p in BENCH.rglob("*.py") if "_cache" not in p.parts)


def _tops(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not set(_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(_tops(path))


def test_whole_names_are_compared():
    from benchmark import run

    sys_modules = dict(sys.modules)
    try:
        sys.modules["ml_audio_inpainting_torch_probe"] = sys
        assert "ml_audio_inpainting_tpu" not in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(sys_modules)


def test_loaded_modules_hold_no_jax():
    code = (
        "import sys\n"
        "from benchmark.reference import gan_serve, cnn_serve, cnn_train\n"
        f"print([m for m in sys.modules if m.split('.')[0] == {PROGRAM!r}])\n"
        "from benchmark import run, spec\n"
        "cell = spec.load_cell('gan_serve_bf16_b32')\n"
        "spec.loop(cell); spec.family(cell); spec.readers(cell)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        f"print(sorted(tops & set({sorted(FORBIDDEN)!r})))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(BENCH.parent)}
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    program_line, jax_line = out.stdout.strip().splitlines()[-2:]
    assert jax_line == "[]"
    assert program_line == "[]", "loading the references imports the program"

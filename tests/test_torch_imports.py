"""The port stands alone: no module of ``ml_audio_inpainting_torch``, not
``chip_smoke.py`` and not the port's scripts (``scripts/torch_*.py``)
imports ``jax``, ``flax`` or ``ml_audio_inpainting_tpu`` (not
even a module there that does not import JAX), and none imports ``yaml`` at
module level (the card's machine has neither JAX nor PyYAML).

Checked twice: on the AST of every file, and by importing every module of
the port (and ``chip_smoke``) in a fresh interpreter and reading
``sys.modules`` there.
"""

import ast
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ml_audio_inpainting_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_audio_inpainting_tpu")
MODULE_LEVEL_FORBIDDEN = FORBIDDEN + ("yaml",)


def _files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    out += [os.path.join(REPO, "scripts", n) for n in os.listdir(os.path.join(REPO, "scripts"))
            if n.startswith("torch_") and n.endswith(".py")]
    for root, _, names in os.walk(PORT):
        out += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imports(tree):
    """(top-level package, at module level?) for every import in ``tree``."""
    module_level = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            yield name.split(".")[0], id(node) in module_level


@pytest.mark.parametrize("path", _files(), ids=lambda p: os.path.relpath(p, REPO))
def test_file_imports_nothing_of_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    assert not _violations(tree), f"{path}: {_violations(tree)}"


def _violations(tree):
    return [
        top for top, at_module_level in _imports(tree)
        if top in FORBIDDEN or (at_module_level and top in MODULE_LEVEL_FORBIDDEN)
    ]


@pytest.mark.parametrize(
    "source,bad",
    [
        ("import jax.numpy as jnp", True),
        ("from flax import linen as nn", True),
        ("from ml_audio_inpainting_tpu.utils.config import Config", True),
        ("def f():\n    import jax", True),
        ("import yaml", True),
        ("def f():\n    import yaml", False),
        ("import torch\nfrom ml_audio_inpainting_torch.ops import stft", False),
    ],
)
def test_checker_flags_forbidden_imports(source, bad):
    assert bool(_violations(ast.parse(source))) == bad


def test_port_package_has_every_slice_module():
    names = {m.name for m in pkgutil.walk_packages([PORT], "ml_audio_inpainting_torch.")}
    for mod in (
        "utils.config", "utils.precision", "ops.gaps", "ops.stft", "ops.masking", "ops.cuda.lstm_cell",
        "ops.lstm", "models.cnn_blstm", "models.build", "weights", "runtime.inference",
        "runtime.serve", "train.features", "train.losses", "train.cnn_trainer",
        "train.checkpoints", "train.recipe", "data.dataset", "ops.pcm", "models.pconv_unet",
        "runtime.transport", "data.multigap", "train.metrics", "train.auditory", "train.peaq",
        "data.audio_io", "data.probe", "cli.inpaint", "cli.evaluate", "models.discriminator",
        "models.vgg", "train.gan_trainer", "data.pipeline", "ops.linalg", "classical",
        "classical.arinpaint", "classical.presets", "classical.janssen", "classical.ola",
        "classical.support", "classical.spain", "classical.basisopt", "classical._slices",
        "cli.ar_benchmark", "cli.train", "models.port_torch", "models.legacy_blstm",
        "utils.run_logging", "utils.visualize",
    ):
        assert f"ml_audio_inpainting_torch.{mod}" in names


def test_importing_the_port_loads_no_jax():
    code = textwrap.dedent(
        f"""
        import importlib, pkgutil, sys
        import ml_audio_inpainting_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        import chip_smoke
        bad = sorted(
            name for name in sys.modules
            if name.split(".")[0] in {MODULE_LEVEL_FORBIDDEN!r}
        )
        print(",".join(bad))
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=180, check=True,
    )
    assert out.stdout.strip() == "", f"modules loaded: {out.stdout.strip()}"

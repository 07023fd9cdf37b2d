"""Checkpoints of the port: the weight export (port of
``ml_audio_inpainting_tpu/train/checkpoints.py::export_params_npz``) and the
training checkpoint manager (the counterpart of its orbax
``CheckpointManager``, ``checkpoints.py:68-114``).

The export is the JAX package's flat ``.npz``: ``/``-joined flax keys
(``params/...`` and ``batch_stats/...``) in flax layouts, f16 by default, so
``ml_audio_inpainting_tpu.train.checkpoints.load_params_npz`` and the port's
``weights.load_params_npz`` both read it.

:class:`CheckpointManager` keeps a train state's every piece, one directory
a step (``<dir>/<step>/state.pt``): the model's ``state_dict`` (parameters,
BatchNorm running statistics, the PatchGAN's spectral-norm ``u`` and
``sigma``), the Adam state with its step counts, the learning-rate
schedule, the EMA and the step.  A save writes CPU copies with
``torch.save`` into a temporary directory and renames it into place, so a
save cut short never stands as a step.  A directory that JAX's orbax wrote
cannot be read here (the port imports no orbax) and is refused.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from ml_audio_inpainting_torch.models.cnn_blstm import StackedBLSTMCNN
from ml_audio_inpainting_torch.models.pconv_unet import PConvUNet
from ml_audio_inpainting_torch.models.refiner import WaveRefiner
from ml_audio_inpainting_torch.weights import (
    cnn_blstm_flat_variables,
    pconv_unet_flat_variables,
    refiner_flat_variables,
)

__all__ = ["export_params_npz", "CheckpointManager", "state_tree", "load_state_tree"]

_FLATTENERS = ((StackedBLSTMCNN, cnn_blstm_flat_variables), (PConvUNet, pconv_unet_flat_variables),
               (WaveRefiner, refiner_flat_variables))
STATE_FILE = "state.pt"


def export_params_npz(
    path: Union[str, Path],
    model: torch.nn.Module,
    dtype: Optional[str] = "float16",
    params: Optional[Mapping[str, torch.Tensor]] = None,
) -> None:
    """Write a :class:`StackedBLSTMCNN`, a :class:`PConvUNet` generator or a
    :class:`WaveRefiner` head as a flat ``.npz`` of flax variables; any
    other module is a ``TypeError``.
    ``params`` replaces parameters of ``model`` by name (e.g. the EMA
    parameters, written with the model's running statistics).  f32 arrays
    are stored as ``dtype`` (f16 by default, as the committed checkpoints
    are), or kept with ``dtype=None``."""
    flatten = next((f for cls, f in _FLATTENERS if isinstance(model, cls)), None)
    if flatten is None:
        raise TypeError(f"export_params_npz writes a StackedBLSTMCNN, a PConvUNet or a "
                        f"WaveRefiner, not a {type(model).__name__}")
    state = model.state_dict()
    unknown = set(params or {}) - set(state)
    if unknown:
        raise KeyError(f"params not in the model: {sorted(unknown)}")
    flat = flatten({**state, **(params or {})})
    if dtype is not None:
        flat = {k: v.astype(dtype) if v.dtype == np.float32 else v for k, v in flat.items()}
    np.savez_compressed(path, **flat)


def _cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def state_tree(state: Any) -> Any:
    """The checkpointed content of ``state`` as CPU copies: a train state
    (a dataclass with ``model``, ``optimizer``, optional ``scheduler``,
    ``ema_params`` and ``step``, as ``CNNTrainState`` and ``GANState``) or
    a dict of them (the GAN's ``{"g": ..., "d": ...}``)."""
    if isinstance(state, Mapping):
        return {k: state_tree(v) for k, v in state.items()}
    if not dataclasses.is_dataclass(state):
        raise TypeError(f"cannot checkpoint a {type(state).__name__}")
    scheduler = getattr(state, "scheduler", None)
    return _cpu({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": None if scheduler is None else scheduler.state_dict(),
        "ema_params": state.ema_params,
        "step": int(state.step),
    })


def _check_same(what: str, got: Mapping, want: Mapping) -> None:
    if set(got) != set(want):
        raise ValueError(f"{what}: checkpoint keys {sorted(set(got) ^ set(want))} differ from "
                         "the template's")
    for k, v in want.items():
        if torch.is_tensor(v) and (got[k].shape != v.shape or got[k].dtype != v.dtype):
            raise ValueError(f"{what} {k}: checkpoint {tuple(got[k].shape)} {got[k].dtype}, "
                             f"template {tuple(v.shape)} {v.dtype}")


def load_state_tree(template: Any, tree: Any) -> Any:
    """Load ``tree`` (from :func:`state_tree`) into ``template`` strictly, in
    place, onto the template's devices, and return ``template``: keys,
    shapes and dtypes must match, and a schedule or EMA must be present in
    both or neither."""
    if isinstance(template, Mapping):
        if set(template) != set(tree):
            raise ValueError(f"checkpoint holds {sorted(tree)}, the template {sorted(template)}")
        for k in template:
            load_state_tree(template[k], tree[k])
        return template
    _check_same("model", tree["model"], template.model.state_dict())
    template.model.load_state_dict(tree["model"])
    template.optimizer.load_state_dict(tree["optimizer"])
    scheduler = getattr(template, "scheduler", None)
    if (scheduler is None) != (tree["scheduler"] is None):
        raise ValueError("the checkpoint and the template differ in having a learning-rate "
                         "schedule")
    if scheduler is not None:
        scheduler.load_state_dict(tree["scheduler"])
    if (template.ema_params is None) != (tree["ema_params"] is None):
        raise ValueError("the checkpoint and the template differ in having an EMA (pass the "
                         "--ema of the run that saved it)")
    if template.ema_params is not None:
        _check_same("ema_params", tree["ema_params"], template.ema_params)
        with torch.no_grad():
            for k, v in template.ema_params.items():
                v.copy_(tree["ema_params"][k])
    template.step = int(tree["step"])
    return template


class CheckpointManager:
    """Train-state checkpoints under ``directory``, one subdirectory a step.

    ``save(step, state, force=False)`` writes ``state`` (see
    :func:`state_tree`) when ``step`` is past the latest saved step and is a
    multiple of ``save_interval_steps`` or nothing is saved yet, or when
    ``force``; a step already saved is skipped (idempotent), as orbax's
    manager does.  ``save_tree`` writes a tree made already (a sharded
    state's ``parallel/sharding.py::gather_state``, in the one-device
    layout).  Then only the ``max_to_keep`` newest steps are kept (all
    with None).  ``restore(template, step=None)`` loads the latest step (or
    ``step``) into ``template`` in place and returns it.  Saving is
    synchronous: ``wait`` and ``close`` are there for the JAX manager's
    callers."""

    def __init__(self, directory: Union[str, Path], max_to_keep: Optional[int] = None,
                 save_interval_steps: int = 1):
        self.directory = Path(directory).resolve()
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.directory.mkdir(parents=True, exist_ok=True)
        self._check_not_orbax()

    def _check_not_orbax(self) -> None:
        foreign = [p.name for p in self.directory.iterdir()
                   if p.is_dir() and p.name.isdigit() and not (p / STATE_FILE).is_file()]
        if foreign:
            raise ValueError(
                f"{self.directory} holds steps {sorted(foreign)} that this port did not write "
                "(an orbax directory of the JAX package?): the port reads no orbax. Export its "
                "weights with the JAX package's train.checkpoints.export_params_npz and pass the "
                ".npz instead")

    def all_steps(self) -> List[int]:
        self._check_not_orbax()
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit() and (p / STATE_FILE).is_file())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save ``state`` at ``step``; True when it was written."""
        return self.save_tree(step, state_tree(state), force)

    def save_tree(self, step: int, tree: Any, force: bool = False) -> bool:
        """Save a :func:`state_tree` at ``step``; True when it was written."""
        steps = self.all_steps()
        if step in steps:
            return False
        if not force and steps and steps[-1] >= step:
            return False
        if not force and steps and step % self.save_interval_steps:
            return False
        tmp = Path(tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.directory))
        try:
            torch.save(tree, tmp / STATE_FILE)
            os.replace(tmp, self.directory / str(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.directory / str(old))
        return True

    def load_tree(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The saved tree of ``step`` (the latest by default), on the CPU."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        path = self.directory / str(step) / STATE_FILE
        if not path.is_file():
            raise FileNotFoundError(f"no checkpoint of step {step} under {self.directory}")
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        return load_state_tree(template, self.load_tree(step))

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass

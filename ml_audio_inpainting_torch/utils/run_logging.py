"""Run management of the training CLI (port of
``ml_audio_inpainting_tpu/utils/run_logging.py``): run directories, a log
file and a stderr logger, the config dump at start, and TensorBoard
scalars, audio and figures through ``tensorboardX`` where it is installed.

Runs are named ``<run_name>_<YYYYmmdd_HHMMSS>``.  The config is dumped as
YAML where ``yaml`` is installed, as in the JAX package, and as JSON where
it is not (the card's machine has no YAML package).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
from datetime import datetime
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["RunContext", "config_text"]


def config_text(cfg) -> str:
    """``cfg`` as YAML (``yaml.safe_dump``, keys in order) where ``yaml`` is
    installed, else as indented JSON."""
    tree = dataclasses.asdict(cfg)
    try:
        import yaml
    except ImportError:
        return json.dumps(tree, indent=2)
    return yaml.safe_dump(tree, sort_keys=False)


class RunContext:
    """Creates the run's directories under ``base_dir`` (``cfg.paths``:
    checkpoints, logs, samples, tensorboard), a log file and a stderr
    handler, and a TensorBoard writer where ``tensorboardX`` is
    installed.  A ``primary=False`` context (a rank of a multi-device run
    other than the first) names the same paths but creates nothing, logs
    nothing and has no writer."""

    def __init__(self, cfg, run_name: Optional[str] = None, base_dir: str = ".",
                 primary: bool = True):
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        name = run_name or cfg.logging.run_name
        self.run_name = f"{name}_{stamp}"
        base = Path(base_dir)
        self.checkpoint_dir = base / cfg.paths.checkpoint_dir / self.run_name
        self.log_dir = base / cfg.paths.log_dir
        self.sample_dir = base / cfg.paths.sample_dir / self.run_name
        self.tb_dir = base / cfg.paths.tensorboard_dir / self.run_name
        self.logger = logging.getLogger(f"{__name__}.{self.run_name}.{id(self)}")
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        self._handlers = []
        self.writer = None
        if not primary:
            self.logger.addHandler(logging.NullHandler())
            return
        for d in (self.checkpoint_dir, self.log_dir, self.sample_dir, self.tb_dir):
            d.mkdir(parents=True, exist_ok=True)

        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        self._handlers = [logging.FileHandler(self.log_dir / f"{self.run_name}.log"),
                          logging.StreamHandler(sys.stderr)]
        for h in self._handlers:
            h.setFormatter(fmt)
            self.logger.addHandler(h)

        self.logger.info("config:\n%s", config_text(cfg))

        try:
            from tensorboardX import SummaryWriter

            self.writer = SummaryWriter(str(self.tb_dir))
        except Exception:  # TensorBoard is optional
            self.writer = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), step)

    def audio(self, tag: str, audio: np.ndarray, step: int, sample_rate: int = 16000) -> None:
        if self.writer is None:
            return
        try:
            self.writer.add_audio(tag, np.asarray(audio)[None, :], step, sample_rate=sample_rate)
        except Exception as e:  # tensorboardX needs soundfile to encode
            self.logger.debug("TensorBoard audio logging unavailable: %s", e)

    def figure(self, tag: str, fig, step: int) -> None:
        if self.writer is None:
            return
        try:
            self.writer.add_figure(tag, fig, step)
        except Exception as e:
            self.logger.debug("TensorBoard figure logging unavailable: %s", e)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        for h in self._handlers:
            self.logger.removeHandler(h)
            h.close()

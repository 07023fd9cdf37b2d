"""Configuration tree of the port: the CNN+BiLSTM serving and training subset.

A copy of the dataclasses of ``ml_audio_inpainting_tpu/utils/config.py``
that the CNN+BiLSTM serving and training paths read, with the same field
names, defaults and YAML key layout, so a config file loads the same in both
packages.  Sections and keys the paths do not read (GAN model and its
optimizers, paths, logging, mesh) are ignored by :meth:`Config.from_dict`.

``yaml`` is imported only inside :meth:`Config.from_yaml`: code that builds
its config in Python needs no YAML package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

__all__ = [
    "SpectrogramConfig",
    "DataConfig",
    "CNNBLSTMConfig",
    "ModelConfig",
    "TrainingConfig",
    "Config",
    "DEFAULT_SAMPLE_RATE",
    "DEFAULT_N_FFT",
    "DEFAULT_HANN_WINDOW_SIZE",
    "DEFAULT_HANN_HOP_LENGTH",
]

DEFAULT_SAMPLE_RATE = 16000
DEFAULT_N_FFT = 512
DEFAULT_HANN_WINDOW_SIZE = 384  # 24 ms at 16 kHz
DEFAULT_HANN_HOP_LENGTH = 192  # 12 ms


def _filtered(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass(frozen=True)
class SpectrogramConfig:
    """STFT profile; the defaults are the CNN+BiLSTM profile 512/192/384."""

    n_fft: int = DEFAULT_N_FFT
    hop_length: int = DEFAULT_HANN_HOP_LENGTH
    win_length: int = DEFAULT_HANN_WINDOW_SIZE
    window: str = "hann"
    normalize: bool = True
    power: float = 1.0

    @property
    def freq_bins(self) -> int:
        return self.n_fft // 2 + 1

    def frames(self, n_samples: int) -> int:
        return 1 + n_samples // self.hop_length


@dataclass
class DataConfig:
    dataset: str = "LibriSpeech"
    root_path: str = ""
    sample_rate: int = DEFAULT_SAMPLE_RATE
    train_path: str = "train-clean-100"
    valid_path: str = "dev-clean"
    test_path: str = "test-clean"
    max_len_s: float = 5.0
    gap_len_s: float = 0.2
    train_limit: Optional[int] = None
    n_files: Optional[int] = None
    gaps_per_audio: int = 1
    train_n_gaps: int = 1
    spectrogram: SpectrogramConfig = field(default_factory=SpectrogramConfig)

    @property
    def max_samples(self) -> int:
        return int(self.sample_rate * self.max_len_s)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DataConfig":
        d = dict(d)
        spec = d.pop("spectrogram", {})
        cfg = cls(**_filtered(cls, d))
        cfg.spectrogram = SpectrogramConfig(**_filtered(SpectrogramConfig, spec))
        return cfg


@dataclass
class CNNBLSTMConfig:
    """CNN encoder -> BiLSTM bottleneck -> CNN decoder."""

    in_channels: int = 1
    num_lstm_layers: int = 3
    lstm_hidden_dim: int = 128
    enc_filters: List[int] = field(default_factory=lambda: [16, 32])
    dec_filters: List[int] = field(default_factory=lambda: [16, 32])


@dataclass
class ModelConfig:
    cnn_blstm: CNNBLSTMConfig = field(default_factory=CNNBLSTMConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        cfg = cls()
        # The CNN+BiLSTM keys sit at the top level of `model:`.
        cnn_keys = _filtered(CNNBLSTMConfig, d)
        if cnn_keys:
            cfg.cnn_blstm = CNNBLSTMConfig(**cnn_keys)
        return cfg


@dataclass
class TrainingConfig:
    """The CNN+BiLSTM optimizer keys (``cnn_blstm.yaml:32-37``)."""

    batch_size: int = 8
    optimizer_type: str = "adam"
    starter_learning_rate: float = 1e-4
    lr_decay: float = 1.0
    max_n_epochs: int = 50


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        cfg = cls()
        if "data" in d:
            cfg.data = DataConfig.from_dict(d["data"])
        if "model" in d:
            cfg.model = ModelConfig.from_dict(d["model"])
        if "training" in d:
            cfg.training = TrainingConfig(**_filtered(TrainingConfig, d["training"]))
        return cfg

    @classmethod
    def from_yaml(cls, path: Union[str, Path]) -> "Config":
        import yaml

        with open(path, "r") as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

"""Configuration tree of the port: the CNN+BiLSTM and the GAN, serving and
training.

A copy of the dataclasses of ``ml_audio_inpainting_tpu/utils/config.py``,
with the same field names, defaults and YAML key layout, so a config file
loads the same in both packages: data, model and training (with its resume
keys), and the run's ``paths``, ``logging`` and ``mesh`` sections that the
training CLI reads (``cli/train.py``; the mesh is recorded, one device).

``yaml`` is imported only inside :meth:`Config.from_yaml`, and only for a
file that is not JSON: code that builds its config in Python
(``gan_profile_config(None)``, ``Config()``) or reads a ``.json`` config
needs no YAML package (JSON is YAML, so the JAX package's ``load_config``
reads the same file the same way).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

__all__ = [
    "SpectrogramConfig",
    "DataConfig",
    "GeneratorConfig",
    "DiscriminatorConfig",
    "CNNBLSTMConfig",
    "ModelConfig",
    "TrainingConfig",
    "PathsConfig",
    "LoggingConfig",
    "MeshConfig",
    "Config",
    "load_config",
    "gan_profile_config",
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
class GeneratorConfig:
    """PConv U-Net generator: ``(out_channels, kernel, stride)`` a stage."""

    input_channels: int = 1
    mask_channels: int = 1
    output_channels: int = 1
    enc_layer_cfg: List[Tuple[int, int, int]] = field(
        default_factory=lambda: [
            (64, 7, 2),
            (128, 5, 2),
            (256, 5, 2),
            (512, 3, 2),
            (512, 3, 2),
            (512, 3, 2),
            (512, 3, 2),
        ]
    )
    dec_layer_cfg: List[Tuple[int, int, int]] = field(
        default_factory=lambda: [
            (512, 3, 1),
            (512, 3, 1),
            (512, 3, 1),
            (256, 3, 1),
            (128, 3, 1),
            (64, 3, 1),
        ]
    )
    final_interim_ch: int = 64
    final_kernel: int = 3


@dataclass
class DiscriminatorConfig:
    """Spectral-norm PatchGAN: ``(out_channels, stride)`` a block."""

    input_channels: int = 1
    layer_cfg: List[Tuple[int, int]] = field(
        default_factory=lambda: [(64, 2), (128, 2), (256, 2), (512, 1)]
    )
    kernel_size: int = 4
    use_spectral_norm: bool = True


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
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    discriminator: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    cnn_blstm: CNNBLSTMConfig = field(default_factory=CNNBLSTMConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        cfg = cls()
        if "generator" in d:  # "channels" is informational in the reference YAML
            cfg.generator = GeneratorConfig(**_filtered(GeneratorConfig, d["generator"]))
        if "discriminator" in d:
            # As the JAX package: a YAML "use_spectral_norm" is dropped, so
            # spectral norm stays on.
            dd = {k: v for k, v in d["discriminator"].items() if k != "use_spectral_norm"}
            cfg.discriminator = DiscriminatorConfig(**_filtered(DiscriminatorConfig, dd))
        # The CNN+BiLSTM keys sit at the top level of `model:`.
        cnn_keys = _filtered(CNNBLSTMConfig, d)
        if cnn_keys:
            cfg.cnn_blstm = CNNBLSTMConfig(**cnn_keys)
        return cfg


@dataclass
class TrainingConfig:
    """The GAN's optimizers and loss weights (``configs/gan.yaml``) and the
    CNN+BiLSTM optimizer keys (``cnn_blstm.yaml:32-37``)."""

    batch_size: int = 8
    epochs: int = 100
    g_lr: float = 2e-4
    d_lr: float = 2e-4
    b1: float = 0.5
    b2: float = 0.999
    lambda_adv: float = 0.01
    lambda_l1_valid: float = 1.0
    lambda_l1_hole: float = 2.0
    lambda_vgg_perceptual: float = 4.0
    lambda_vgg_style: float = 500.0
    lambda_mag_weighted: float = 0.2
    optimizer_type: str = "adam"
    starter_learning_rate: float = 1e-4
    lr_decay: float = 1.0
    max_n_epochs: int = 50
    resume_from_chkpt: bool = False
    resume_run_name: Optional[str] = None
    resume_epoch: Optional[int] = None


@dataclass
class PathsConfig:
    """Where a training run writes, under the CLI's ``--base-dir``."""

    tensorboard_dir: str = "./tensorboard"
    checkpoint_dir: str = "./checkpoints"
    log_dir: str = "./logs"
    sample_dir: str = "./samples"
    resume_mdl_path: Optional[str] = None


@dataclass
class LoggingConfig:
    """The training CLI's intervals, in steps (``checkpoint_interval`` in
    epochs) and its default run name."""

    log_interval: int = 100
    checkpoint_interval: int = 5
    sample_interval: int = 500
    metric_interval: int = 25
    spectrogram_interval: int = 100
    audio_interval: int = 500
    num_workers: int = 4
    run_name: str = "run"


@dataclass
class MeshConfig:
    """The JAX package's device-mesh layout, kept so a config round-trips;
    the port trains on one device."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1
    model_parallel: int = 1


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        cfg = cls()
        if "data" in d:
            cfg.data = DataConfig.from_dict(d["data"])
        if "model" in d:
            cfg.model = ModelConfig.from_dict(d["model"])
        for name, section in (("training", TrainingConfig), ("paths", PathsConfig),
                              ("logging", LoggingConfig), ("mesh", MeshConfig)):
            if name in d:
                setattr(cfg, name, section(**_filtered(section, d[name])))
        return cfg

    @classmethod
    def from_yaml(cls, path: Union[str, Path]) -> "Config":
        """The config of a YAML file; a file whose text is JSON is parsed
        with ``json`` (no YAML package needed)."""
        text = Path(path).read_text()
        try:
            tree = json.loads(text)
        except ValueError:
            import yaml

            tree = yaml.safe_load(text)
        return cls.from_dict(tree or {})

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def load_config(config_path: Union[str, Path]) -> Config:
    """The config of a YAML (or JSON) file (this repo's ``configs/*.yaml``
    and the reference's key layout)."""
    return Config.from_yaml(config_path)


def gan_profile_config(config_path: Optional[Union[str, Path]] = None) -> Config:
    """``load_config(config_path)``, or with no file the default
    :class:`Config` on the GAN's STFT profile (n_fft 512, hop 128, window
    512): the GAN checkpoints are bound to that profile, and the default
    (CNN+BiLSTM) one would score them wrongly."""
    if config_path is not None:
        return load_config(config_path)
    cfg = Config()
    cfg.data.spectrogram = SpectrogramConfig(n_fft=512, hop_length=128, win_length=512)
    return cfg

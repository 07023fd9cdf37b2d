"""CNN+BiLSTM training step (port of
``ml_audio_inpainting_tpu/train/cnn_trainer.py``).

One step: features from waveforms and gap positions, the forward pass in
train mode (batch statistics in BatchNorm, the BiLSTM through the
``lstm_fwd`` kernel with its cell states kept), the gap L1 loss, the backward
pass (``lstm_bwd`` and ``lstm_dwhh`` on the card), Adam, and the EMA of the
parameters.  The forward and backward passes run their convolutions in full
f32 (TF32 off in a scope), as the JAX reference on the CPU does.  The JAX step is a pure function of its state; this one updates
the state's model, optimizer and EMA in place and returns the same state.

Mixed precision (``compute_dtype=torch.bfloat16``) is the JAX recipe
(``cnn_trainer.py:128-136``), not ``torch.autocast``: the master weights,
Adam's state, the EMA, the loss, the features and BatchNorm's running
statistics stay f32, and the network's forward and backward run on bf16
casts of the parameters and of the network input, made inside the graph
(``torch.func.functional_call``), so every op of the network runs in bf16
and the f32 masters receive the bf16 gradients upcast by the casts'
backward.  The loss is taken on the prediction upcast to f32.

Adam is ``torch.optim.Adam`` with optax's defaults (b1 0.9, b2 0.999, eps
1e-8 added outside the square root, bias-corrected), which compute the same
update as ``optax.adam``; ``optax.exponential_decay(lr, 1, d)`` becomes an
``ExponentialLR(gamma=d)`` stepped after every update, so step k uses
``lr * d**k`` in both.  The JAX package's initial weights come from its own
``jax.random`` stream, which cannot be reproduced: pass them as flat flax
variables (``params``) to start from the same point, or let the port draw
fresh ones from the same distributions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ml_audio_inpainting_torch.models.build import build_model
from ml_audio_inpainting_torch.models.cnn_blstm import StackedBLSTMCNN
from ml_audio_inpainting_torch.parallel.collectives import sum_gradients
from ml_audio_inpainting_torch.runtime.profiling import span
from ml_audio_inpainting_torch.train.features import cnn_features, cnn_phase_features
from ml_audio_inpainting_torch.train.losses import cnn_gap_l1_loss, cnn_phase_l1_loss
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.utils.precision import cast_floating, full_f32_convolutions
from ml_audio_inpainting_torch.weights import cnn_blstm_state_dict

__all__ = ["CNNTrainState", "create_cnn_state", "make_cnn_train_step", "make_cnn_eval_step"]

ADAM_BETAS = (0.9, 0.999)  # optax.adam defaults
ADAM_EPS = 1e-8


@dataclass
class CNNTrainState:
    """The model (parameters and BatchNorm running statistics), its Adam
    optimizer and learning-rate schedule, the parameters' EMA (``None`` when
    off; serving weights the optimizer never sees), the step count, and the
    parameters a mesh split over its ``model`` axis
    (``parallel/sharding.py::place_state``; empty on one device)."""

    model: StackedBLSTMCNN
    optimizer: torch.optim.Adam
    scheduler: Optional[torch.optim.lr_scheduler.ExponentialLR]
    ema_params: Optional[Dict[str, torch.Tensor]]
    step: int = 0
    shardings: Dict[str, Any] = field(default_factory=dict)


def create_cnn_state(
    cfg: Config,
    device="cuda",
    params: Optional[Mapping[str, np.ndarray]] = None,
    ema: float = 0.0,
    seed: int = 0,
) -> CNNTrainState:
    """Model, Adam (lr ``cfg.training.starter_learning_rate``) and, with
    ``ema > 0``, an EMA seeded with a copy of the initial parameters.

    ``params`` are flat flax variables (``params/...`` and
    ``batch_stats/...`` keys, as :func:`~ml_audio_inpainting_torch.weights.load_params_npz`
    returns them), loaded strictly; without them the weights are drawn with
    the JAX init's distributions from a ``torch.Generator`` seeded with
    ``seed``.
    """
    if cfg.training.optimizer_type != "adam":
        raise ValueError(f"optimizer_type {cfg.training.optimizer_type!r}: the CNN+BiLSTM "
                         "recipe trains with adam")
    model = build_model(cfg, device)
    if params is not None:
        model.load_state_dict(cnn_blstm_state_dict(params))
    else:
        model.init_weights(torch.Generator().manual_seed(seed))
    model.train()
    optimizer = torch.optim.Adam(
        model.parameters(), lr=cfg.training.starter_learning_rate, betas=ADAM_BETAS,
        eps=ADAM_EPS,
    )
    scheduler = None
    if cfg.training.lr_decay != 1.0:
        scheduler = torch.optim.lr_scheduler.ExponentialLR(optimizer, gamma=cfg.training.lr_decay)
    ema_params = None
    if ema > 0:
        ema_params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return CNNTrainState(model, optimizer, scheduler, ema_params)


def _check_supported(cfg: Config, compute_dtype, phase_mode: bool, phase_anchor: bool) -> None:
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype}: the CNN+BiLSTM trains in f32 or "
                         "bfloat16")
    if phase_anchor and not phase_mode:
        raise ValueError("phase_anchor requires phase_mode")
    if phase_mode and cfg.model.cnn_blstm.in_channels != 2:
        raise ValueError("phase_mode trains the 2-channel model: set "
                         "cfg.model.cnn_blstm.in_channels = 2")
    if phase_mode and cfg.data.train_n_gaps > 1:
        raise ValueError("phase_mode has no multi-gap features (cnn_phase_features is "
                         "single-gap)")


def _batch(cfg: Config, audio: torch.Tensor, gap_start: torch.Tensor,
           gap_len: Optional[torch.Tensor], phase_mode: bool,
           phase_anchor: bool) -> Dict[str, torch.Tensor]:
    """The step's features: ``net_in`` (the model's input), ``gap_mask``,
    and the loss's target, ``target`` (complex) in phase mode, else
    ``target_mag``."""
    if phase_mode:
        batch = cnn_phase_features(audio, gap_start, cfg.data.spectrogram,
                                   gap_len_s=cfg.data.gap_len_s,
                                   sample_rate=cfg.data.sample_rate, anchored=phase_anchor)
        return {**batch, "net_in": batch["spec_gap"]}
    batch = cnn_features(
        audio,
        gap_start,
        cfg.data.spectrogram,
        gap_len_s=cfg.data.gap_len_s,
        sample_rate=cfg.data.sample_rate,
        n_gaps=cfg.data.train_n_gaps,
        gap_len=gap_len,
    )
    return {**batch, "net_in": batch["log_gap"]}


def _loss(pred: torch.Tensor, batch: Dict[str, torch.Tensor], phase_mode: bool) -> torch.Tensor:
    if phase_mode:
        return cnn_phase_l1_loss(pred, batch["target"], batch["gap_mask"])
    return cnn_gap_l1_loss(pred, batch["target_mag"], batch["gap_mask"])


def make_cnn_train_step(
    cfg: Config, ema: float = 0.0, compute_dtype=None, phase_mode: bool = False,
    phase_anchor: bool = False,
) -> Callable[..., Tuple[CNNTrainState, Dict]]:
    """``step(state, audio, gap_start, gap_len=None) -> (state, {"loss":
    loss})``: gaps -> STFTs -> forward (train mode) -> gap L1 -> backward ->
    Adam -> EMA.

    ``audio`` is ``(B, S)`` f32 waveforms on the model's device and
    ``gap_start`` ``(B, G)`` int64 gap positions in samples (``G`` is the
    recipe's ``gaps_per_audio``); with ``cfg.data.train_n_gaps`` K > 1,
    ``gap_start`` and ``gap_len`` are ``(B, G, K)`` gap starts and lengths
    (``data/multigap.py``).  The BatchNorm running statistics move during
    the forward pass, as the JAX step's ``mutable=["batch_stats"]`` output
    replaces them after it.  ``loss`` is a 0-d f32 tensor on the device;
    the step's (f32) gradients stay in the parameters' ``.grad`` until the
    next step.

    ``ema`` > 0 blends ``ema * ema_params + (1 - ema) * params`` after the
    optimizer step.  ``compute_dtype=torch.bfloat16`` runs the network in
    bf16 as the module docstring says (f32 or None: the f32 step).

    ``phase_mode`` trains the complex 2-channel model
    (``cfg.model.cnn_blstm.in_channels == 2``, one gap a variant,
    ``cnn_trainer.py:86-116``): the gapped STFT's real and imaginary parts
    in, the complex L1 on the gap out (:func:`cnn_phase_l1_loss`);
    ``phase_anchor`` rotates the target by the deployable phase anchor
    (:func:`~ml_audio_inpainting_torch.train.features.cnn_phase_features`).
    """
    _check_supported(cfg, compute_dtype, phase_mode, phase_anchor)
    mixed = compute_dtype == torch.bfloat16

    def forward(model: StackedBLSTMCNN, net_in: torch.Tensor) -> torch.Tensor:
        if not mixed:
            return model(net_in)
        params = cast_floating(dict(model.named_parameters()), compute_dtype)
        return torch.func.functional_call(model, params, (net_in.to(compute_dtype),))

    def run(state: CNNTrainState, audio: torch.Tensor, gap_start: torch.Tensor,
            gap_len: Optional[torch.Tensor]):
        model = state.model
        model.train()
        with torch.no_grad(), span("train.features"):
            batch = _batch(cfg, audio, gap_start, gap_len, phase_mode, phase_anchor)
        with span("train.optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        with full_f32_convolutions():  # forward and backward, as the f32 reference
            with span("train.forward"):
                pred = forward(model, batch["net_in"])
                loss = _loss(pred.float(), batch, phase_mode)
            with span("train.backward"):
                loss.backward()
        with span("train.optimizer"):
            params = dict(model.named_parameters())
            sum_gradients(params.values(), split=[params[n] for n in state.shardings])
            state.optimizer.step()
            if state.scheduler is not None:
                state.scheduler.step()
            if ema > 0 and state.ema_params is not None:
                with torch.no_grad():
                    for name, p in model.named_parameters():
                        e = state.ema_params[name]
                        e.copy_(ema * e + (1.0 - ema) * p)
        state.step += 1
        return state, {"loss": loss.detach()}

    def step(state: CNNTrainState, audio: torch.Tensor, gap_start: torch.Tensor,
             gap_len: Optional[torch.Tensor] = None):
        with span("train.step"):
            return run(state, audio, gap_start, gap_len)

    return step


def make_cnn_eval_step(
    cfg: Config, phase_mode: bool = False, phase_anchor: bool = False
) -> Callable[..., Dict]:
    """``step(state, audio, gap_start, gap_len=None) -> {"loss": loss}``:
    the validation loss of the live parameters with BatchNorm's running
    statistics (eval mode), under ``torch.inference_mode``, in f32 as in
    JAX; the gaps, ``phase_mode`` and ``phase_anchor`` as for
    :func:`make_cnn_train_step`.  The model is left in eval mode; the train
    step switches it back."""
    _check_supported(cfg, None, phase_mode, phase_anchor)

    @torch.inference_mode()
    def step(state: CNNTrainState, audio: torch.Tensor, gap_start: torch.Tensor,
             gap_len: Optional[torch.Tensor] = None):
        state.model.eval()
        batch = _batch(cfg, audio, gap_start, gap_len, phase_mode, phase_anchor)
        with full_f32_convolutions():
            pred = state.model(batch["net_in"])
        return {"loss": _loss(pred, batch, phase_mode)}

    return step

"""Adversarial training of the GAN (port of
``ml_audio_inpainting_tpu/train/gan_trainer.py``).

One step, as the JAX step orders it: features from waveforms and gap
positions; the discriminator (D) step, BCE on real and on the detached fake;
then the generator (G) step, the six-term objective through the *updated* D
(spectral norm running a power-iteration step from the stored ``u`` but
storing nothing); then the EMA of G's parameters.  The G step re-runs the
generator under autodiff (the JAX package's fix of the reference's
``no_grad`` defect, ``gan_trainer.py:10-14``).  The JAX step is a pure
function of its two states; this one updates the states' models,
optimizers and EMA in place and returns them.

State that moves inside the step, and how it matches JAX's:

* G's BatchNorm running statistics move once a step.  JAX runs the
  generator twice in train mode (the detached fake of the D step, then the
  G step) from the same statistics and keeps the second forward's update,
  which equals the first's; a torch module updates on every train-mode
  forward, so here the first forward keeps its update and every later one
  (the G step's, and any forward that ``remat`` recomputes in the backward)
  runs under :func:`~ml_audio_inpainting_torch.models.cnn_blstm.running_stats_frozen`.
* D's spectral-norm state: the real pass runs from the stored ``u``, the
  fake pass from the ``u`` the real pass produced, and the fake pass's
  ``u`` and ``sigma`` are stored after D's update (``gan_trainer.py:270-286``).
  :meth:`Discriminator.apply_sn` is functional, so a recomputed forward
  sees the same ``u`` it saw first.
* Gradients are taken with ``torch.autograd.grad`` with respect to one
  network's parameters at a time and then stored in their ``.grad`` (where
  they stay until the next step): the G step leaves D's ``.grad`` as the D
  step set it.

Mixed precision (``compute_dtype=torch.bfloat16``) is the JAX rule
(``gan_trainer.py:163-178``), not ``torch.autocast``: the master
parameters, both Adams and the EMA stay f32; G, D and VGG19 run on bf16
casts of their parameters and inputs made inside the graph
(``torch.func.functional_call`` for G); the losses run on f32 upcasts of
the logits and of G's output; G's running statistics stay f32, D's ``u``
is cast to bf16 for the power iteration and stored back in f32; VGG's
preprocessing follows its input's dtype and its reductions run in f32.

``remat`` is ``jax.checkpoint``'s counterpart,
``torch.utils.checkpoint(use_reentrant=False)`` around each differentiated
network forward (G, D on real and on fake, and the VGG terms): the
backward recomputes their activations instead of holding them.  The
convolutions and the matrix products (spectral norm's power iteration and
sigma, VGG's Gram matrices) run in full f32 (TF32 off) in a scope, forward
and backward, whatever the global switches say.

Adam is ``torch.optim.Adam(lr, betas=(b1, b2), eps=1e-8)`` for each
network, which computes ``optax.adam``'s update.  The JAX package's initial
weights come from its own ``jax.random`` stream: pass them as flat flax
variables to start from the same point, or let the port draw fresh ones
from the same distributions.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ml_audio_inpainting_torch.models.build import build_discriminator, build_generator
from ml_audio_inpainting_torch.models.cnn_blstm import running_stats_frozen
from ml_audio_inpainting_torch.models.discriminator import Discriminator
from ml_audio_inpainting_torch.models.pconv_unet import PConvUNet
from ml_audio_inpainting_torch.models.vgg import VGG19Features, vgg_perceptual_style_losses
from ml_audio_inpainting_torch.train.features import gan_features
from ml_audio_inpainting_torch.train.losses import discriminator_loss, generator_losses
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.utils.precision import (
    cast_floating,
    full_f32_convolutions,
    full_f32_matmuls,
)
from ml_audio_inpainting_torch.weights import discriminator_state_dict, pconv_unet_state_dict

__all__ = [
    "GANState",
    "build_generator",
    "build_discriminator",
    "create_gan_states",
    "make_gan_train_step",
    "make_gan_eval_step",
]

ADAM_EPS = 1e-8  # optax.adam's default
# Profiler ranges around each part of a step (``torch.profiler.record_function``):
# ``scripts/torch_gan_training_profile.py`` charges a kernel to the range its
# forward op ran in, and a backward kernel to its forward op's range.
SCOPES = {"features": "gan/features", "G": "gan/G", "D": "gan/D", "VGG": "gan/VGG",
          "optimizer": "gan/adam_ema"}


@dataclass
class GANState:
    """One network (G's PConv U-Net with its BatchNorm running statistics,
    or D with its spectral-norm state), its Adam optimizer, the parameters'
    EMA (``None`` when off; G's serving weights, which the optimizer never
    sees) and the step count."""

    model: nn.Module
    optimizer: torch.optim.Adam
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0


def create_gan_states(
    cfg: Config,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    g_ema: float = 0.0,
    params: Optional[Mapping[str, np.ndarray]] = None,
    d_params: Optional[Mapping[str, np.ndarray]] = None,
) -> Tuple[GANState, GANState]:
    """``(g_state, d_state)``: G and D on ``device`` with their Adams
    (``cfg.training``'s ``g_lr``, ``d_lr``, ``b1``, ``b2``).

    ``params`` and ``d_params`` are flat flax variables of G (``params/``
    and ``batch_stats/``, e.g. a committed npz) and of D (with its
    ``SpectralNorm_*`` state), loaded strictly; a network without them is
    drawn with the JAX init's distributions from ``generator`` (a
    ``torch.Generator`` seeded 0 if none is given), G first.  ``g_ema > 0``
    seeds ``g_state.ema_params`` with a copy of G's parameters."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    t = cfg.training
    gen = build_generator(cfg, device)
    if params is not None:
        gen.load_state_dict(pconv_unet_state_dict(params))
    else:
        gen.init_weights(generator)
    disc = build_discriminator(cfg, device)
    if d_params is not None:
        disc.load_state_dict(discriminator_state_dict(d_params))
    else:
        disc.init_weights(generator)
    gen.train()
    ema = {k: p.detach().clone() for k, p in gen.named_parameters()} if g_ema > 0 else None
    g_state = GANState(gen, torch.optim.Adam(gen.parameters(), lr=t.g_lr, betas=(t.b1, t.b2),
                                             eps=ADAM_EPS), ema)
    d_state = GANState(disc, torch.optim.Adam(disc.parameters(), lr=t.d_lr, betas=(t.b1, t.b2),
                                              eps=ADAM_EPS))
    return g_state, d_state


def _lambdas(cfg: Config) -> Dict[str, float]:
    t = cfg.training
    return {name: getattr(t, name) for name in (
        "lambda_adv", "lambda_l1_valid", "lambda_l1_hole", "lambda_mag_weighted",
        "lambda_vgg_perceptual", "lambda_vgg_style")}


def _use_vgg(cfg: Config, vgg: Optional[VGG19Features]) -> bool:
    t = cfg.training
    return vgg is not None and (t.lambda_vgg_perceptual > 0 or t.lambda_vgg_style > 0)


def _batch(cfg: Config, audio: torch.Tensor, gap_start: torch.Tensor,
           gap_len: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    return gan_features(
        audio, gap_start, cfg.data.spectrogram, gap_len_s=cfg.data.gap_len_s,
        sample_rate=cfg.data.sample_rate, n_gaps=cfg.data.train_n_gaps, gap_len=gap_len)


def _set_grads(params: List[torch.Tensor], loss: torch.Tensor) -> None:
    """``.grad`` of each of ``params`` set to ``d loss / d param`` (zeros
    where the loss does not depend on it); nothing else accumulates."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g


def make_gan_train_step(
    cfg: Config,
    vgg: Optional[VGG19Features] = None,
    compute_dtype=None,
    remat: bool = False,
    g_ema: float = 0.0,
    fused_g_forward: bool = False,
) -> Callable[..., Tuple[GANState, GANState, Dict[str, torch.Tensor]]]:
    """``step(g_state, d_state, audio, gap_start, gap_len=None) -> (g_state,
    d_state, metrics)``: gaps -> STFTs -> D step -> G step -> EMA.

    ``audio`` is ``(B, S)`` f32 waveforms on the models' device;
    ``gap_start`` is ``(B,)`` int64 gap starts in samples, or with
    ``cfg.data.train_n_gaps`` K > 1, ``gap_start`` and ``gap_len`` are
    ``(B, K)`` starts and lengths (``train/recipe.py::gan_gap_layouts``).
    ``metrics`` holds the seven generator terms and ``d_total``,
    ``d_real``, ``d_fake``, as 0-d f32 device tensors (no host sync inside
    the step).

    ``vgg`` is the frozen :func:`~ml_audio_inpainting_torch.models.vgg.vgg19_params`
    model, or None to drop the VGG terms (as with both lambdas 0).
    ``compute_dtype=torch.bfloat16`` runs the networks in bf16 as the module
    docstring says (None or f32: the f32 step).  ``remat`` recomputes each
    network's activations in the backward.  ``g_ema > 0`` blends ``g_ema *
    ema + (1 - g_ema) * params`` after G's update (parameters only).
    ``fused_g_forward`` runs G forward once a step and shares it between
    the D step (detached) and the G step (the JAX package's recorded
    experiment; the default runs it twice, as JAX's default does)."""
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype}: the GAN trains in f32 or bfloat16")
    mixed = compute_dtype == torch.bfloat16
    cast = (lambda tree: cast_floating(tree, compute_dtype)) if mixed else (lambda tree: tree)
    lambdas = _lambdas(cfg)
    use_vgg = _use_vgg(cfg, vgg)
    if use_vgg and mixed:
        vgg = copy.deepcopy(vgg).to(compute_dtype)

    def maybe_checkpoint(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    def step(g_state: GANState, d_state: GANState, audio: torch.Tensor,
             gap_start: torch.Tensor, gap_len: Optional[torch.Tensor] = None):
        gen: PConvUNet = g_state.model
        disc: Discriminator = d_state.model
        gen.train()
        with torch.no_grad(), record_function(SCOPES["features"]):
            batch = _batch(cfg, audio, gap_start, gap_len)
        orig, impaired, mask = batch["original_magnitude"], batch["impaired_magnitude"], batch["mask"]
        orig_c, impaired_c, mask_c = cast(orig), cast(impaired), cast(mask)
        g_leaves = list(gen.parameters())
        d_leaves = list(disc.parameters())

        def g_forward(first_run_updates: bool):
            """G on the step's input, in train mode; only the first run of
            this forward (not a recomputation) may move the running
            statistics, and only if ``first_run_updates``."""
            runs = [0]

            def fn(x, m):
                frozen = runs[0] > 0 or not first_run_updates
                runs[0] += 1
                with running_stats_frozen(gen, frozen), record_function(SCOPES["G"]):
                    return torch.func.functional_call(
                        gen, cast(dict(gen.named_parameters())), (x, m))
            if not torch.is_grad_enabled():  # the detached fake keeps no activations
                return fn(impaired_c, mask_c)
            return maybe_checkpoint(fn, impaired_c, mask_c)

        with full_f32_convolutions(), full_f32_matmuls():
            # --- D step: real, then the detached fake from the u real produced ---
            if fused_g_forward:
                fake = g_forward(first_run_updates=True)
                fake_detached = fake.detach()
            else:
                with torch.no_grad():
                    fake_detached = g_forward(first_run_updates=True)
            d_params = cast(dict(disc.named_parameters()))

            def d_train(x, u):
                with record_function(SCOPES["D"]):
                    return disc.apply_sn(d_params, u, x)

            us = [cast(u) for u in disc.sn_state()]
            d_real, us, _ = maybe_checkpoint(d_train, orig_c, us)
            d_fake, us, sigmas = maybe_checkpoint(d_train, fake_detached, us)
            d_losses = discriminator_loss(d_real.float(), d_fake.float())
            _set_grads(d_leaves, d_losses["d_total"])
            with record_function(SCOPES["optimizer"]):
                d_state.optimizer.step()
            disc.store_sn_state(us, sigmas)

            # --- G step through the updated D (power iteration, nothing stored) ---
            d_params = cast({k: v.detach() for k, v in disc.named_parameters()})
            us_now = [cast(u) for u in disc.sn_state()]

            def d_infer(x):
                with record_function(SCOPES["D"]):
                    return disc.apply_sn(d_params, us_now, x)[0]

            def vgg_terms(fake, target):
                with record_function(SCOPES["VGG"]):
                    return vgg_perceptual_style_losses(vgg, fake, target)

            if not fused_g_forward:
                fake = g_forward(first_run_updates=False)
            d_fake_logits = maybe_checkpoint(d_infer, fake)
            vgg_losses = maybe_checkpoint(vgg_terms, fake, orig_c) if use_vgg else None
            g_losses = generator_losses(fake.float(), orig, mask, d_fake_logits.float(), lambdas,
                                        vgg_losses)
            _set_grads(g_leaves, g_losses["g_total"])
        with record_function(SCOPES["optimizer"]):
            g_state.optimizer.step()
        if g_ema > 0 and g_state.ema_params is not None:
            with torch.no_grad(), record_function(SCOPES["optimizer"]):
                for name, p in gen.named_parameters():
                    e = g_state.ema_params[name]
                    e.copy_(g_ema * e + (1.0 - g_ema) * p)
        g_state.step += 1
        d_state.step += 1
        metrics = {k: v.detach() for k, v in {**g_losses, **d_losses}.items()}
        return g_state, d_state, metrics

    return step


def make_gan_eval_step(
    cfg: Config, vgg: Optional[VGG19Features] = None
) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(g_state, d_state, audio, gap_start, gap_len=None) -> metrics``:
    the train step's losses of the live parameters with no update, in f32,
    under ``torch.inference_mode``: G in eval mode (BatchNorm's running
    statistics), D on the fake and on the real with its stored ``u``
    (nothing stored).  G is left in eval mode; the train step switches it
    back."""
    lambdas = _lambdas(cfg)
    use_vgg = _use_vgg(cfg, vgg)

    @torch.inference_mode()
    def step(g_state: GANState, d_state: GANState, audio: torch.Tensor,
             gap_start: torch.Tensor, gap_len: Optional[torch.Tensor] = None):
        gen, disc = g_state.model, d_state.model
        gen.eval()
        batch = _batch(cfg, audio, gap_start, gap_len)
        orig, impaired, mask = batch["original_magnitude"], batch["impaired_magnitude"], batch["mask"]
        with full_f32_convolutions(), full_f32_matmuls():
            fake = gen(impaired, mask)
            d_fake = disc(fake)
            d_real = disc(orig)
            vgg_losses = vgg_perceptual_style_losses(vgg, fake, orig) if use_vgg else None
        return {**generator_losses(fake, orig, mask, d_fake, lambdas, vgg_losses),
                **discriminator_loss(d_real, d_fake)}

    return step

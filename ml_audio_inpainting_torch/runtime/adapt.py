"""Per-clip test-time adaptation of the GAN generator (port of
``ml_audio_inpainting_tpu/runtime/adapt.py``).

At serving time the impaired clip's own context is real audio from the
distribution to inpaint.  The adapter fine-tunes a copy of the generator on
it:

1. the real gap is filled by the AR solver (``classical/arinpaint.py``), so
   the target is defined everywhere: the AR fill inside the real gap, the
   true samples outside;
2. the copy takes G-only steps (the L1 valid and hole losses and the
   magnitude-weighted loss; no adversary and no VGG) on synthetic gaps
   drawn over this pseudo-clean clip;
3. an in-clip probe scores synthetic gaps away from the real gap, through
   the serving path itself (its mode and phase regime), every
   ``probe_every`` steps, and the best-scoring weights are served, step 0
   (no adaptation) included.

Nothing consumed derives from the real gap's lost samples.  The JAX
package's record (its TPU, nine LibriSpeech clips) is a loss in gap SDR
with better LSD and ODG; the default is no adaptation.

torch is not functional, so where JAX's adapter returns new variables, this
one adapts a deep copy of the generator for each clip, starting again from
the generator it is given, which it never writes to; the probe-best weights
are kept as cloned tensors (Adam updates the copy in place).  The gap draws
of the steps come from a ``torch.Generator`` on the device (JAX's from
``jax.random``), so the two packages adapt on other gaps.  Between probes
the steps make no host sync; each probe reads one float, as JAX's does.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ml_audio_inpainting_torch.classical.arinpaint import arinpaint
from ml_audio_inpainting_torch.data.multigap import draw_gaps
from ml_audio_inpainting_torch.ops.gaps import gap_mask
from ml_audio_inpainting_torch.train.features import gan_features
from ml_audio_inpainting_torch.train.losses import generator_losses
from ml_audio_inpainting_torch.train.metrics import gap_sdr
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.utils.precision import full_f32_convolutions

__all__ = [
    "make_gan_adapt_step",
    "draw_adapt_gaps",
    "probe_positions_for",
    "GanClipAdapter",
    "adapt_gan_variables",
]

ADAM_EPS = 1e-8  # optax.adam's default


def draw_adapt_gaps(generator: torch.Generator, cfg: Config, batch: int, n_samples: int,
                    n_gaps: int) -> Tuple[torch.Tensor, ...]:
    """The gaps of one adaptation step of ``batch`` clips of ``n_samples``
    (``data/multigap.py::draw_gaps`` with the config's ``gap_len_s``):
    ``(starts,)`` ``(B,)``, or ``(starts, lengths)`` ``(B, n_gaps)``."""
    d = cfg.data
    return draw_gaps(generator, (batch,), n_samples, d.gap_len_s, d.sample_rate, n_gaps)


def make_gan_adapt_step(cfg: Config, lr: float = 5e-5,
                        n_gaps: int = 4) -> Tuple[Callable, Callable]:
    """The G-only fine-tuning step: ``(init_fn, step_fn)``::

        optimizer = init_fn(generator)
        losses = step_fn(generator, optimizer, audio, gap_start, gap_len=None)

    ``init_fn`` is Adam at ``lr`` with the config's ``b1``, ``b2`` (optax's
    rule).  ``step_fn`` updates ``generator`` in place, its parameters and
    (in train mode, flax's momentum rule) its BatchNorm statistics, from the
    features of ``audio (B, S)`` with the gaps of :func:`draw_adapt_gaps`:
    the training losses with lambdas ``l1_valid``, ``l1_hole`` and
    ``mag_weighted`` of the config and no adversarial or VGG term (logits of
    zeros, lambda 0).  ``losses`` are 0-d device tensors; the step makes no
    host sync.  f32, the convolutions in full f32."""
    t = cfg.training
    lambdas = {"lambda_adv": 0.0, "lambda_l1_valid": t.lambda_l1_valid,
               "lambda_l1_hole": t.lambda_l1_hole, "lambda_mag_weighted": t.lambda_mag_weighted,
               "lambda_vgg_perceptual": 0.0, "lambda_vgg_style": 0.0}

    def init_fn(generator: torch.nn.Module) -> torch.optim.Adam:
        return torch.optim.Adam(generator.parameters(), lr=lr, betas=(t.b1, t.b2), eps=ADAM_EPS)

    def step_fn(generator: torch.nn.Module, optimizer: torch.optim.Adam, audio: torch.Tensor,
                gap_start: torch.Tensor, gap_len: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            batch = gan_features(audio, gap_start, cfg.data.spectrogram,
                                 gap_len_s=cfg.data.gap_len_s, sample_rate=cfg.data.sample_rate,
                                 n_gaps=n_gaps, gap_len=gap_len)
        orig, impaired, mask = batch["original_magnitude"], batch["impaired_magnitude"], batch["mask"]
        generator.train()
        with full_f32_convolutions():
            fake = generator(impaired, mask)
            logits = torch.zeros((fake.shape[0], 1, 1, 1), dtype=fake.dtype, device=fake.device)
            losses = generator_losses(fake, orig, mask, logits, lambdas)
            optimizer.zero_grad(set_to_none=True)
            losses["g_total"].backward()
        optimizer.step()
        return {k: v.detach() for k, v in losses.items()}

    return init_fn, step_fn


def probe_positions_for(
    n_samples: int,
    gap_start: int,
    gap_len: int,
    sample_rate: int,
    n_probes: int = 4,
    margin_s: float = 0.35,
    edge_s: float = 0.6,
) -> np.ndarray:
    """Probe-gap start samples spread over the clip, clear of the real gap
    by ``margin_s`` on each side and of the clip's edges by ``edge_s``
    (numpy, as JAX's)."""
    margin = int(margin_s * sample_rate)
    edge = int(edge_s * sample_rate)
    lo, hi = edge, n_samples - edge - gap_len
    grid = np.linspace(lo, hi, num=max(4 * n_probes, 16)).astype(np.int64)
    ok = (grid + gap_len < gap_start - margin) | (grid > gap_start + gap_len + margin)
    cand = grid[ok]
    if len(cand) == 0:
        raise ValueError("no probe positions clear of the real gap")
    pick = np.linspace(0, len(cand) - 1, num=min(n_probes, len(cand))).astype(int)
    return cand[pick]


class GanClipAdapter:
    """Per-clip adapter: one step function and one settings set for every
    clip.  ``inpaint_factory(generator)`` returns the serving function
    ``fn(audio, gap_start, gap_len) -> (restored, aux)`` of a generator (the
    CLI's regime, shifts and precision); the probe scores through it."""

    def __init__(
        self,
        cfg: Config,
        inpaint_factory: Callable,
        *,
        steps: int = 200,
        lr: float = 5e-5,
        batch: int = 8,
        probe_every: int = 25,
        n_probes: int = 4,
        n_gaps: int = 4,
        ar_order: int = 512,
        ar_context: int = 4096,
    ):
        self.cfg = cfg
        self.inpaint_factory = inpaint_factory
        self.steps = steps
        self.batch = batch
        self.probe_every = probe_every
        self.n_probes = n_probes
        self.n_gaps = n_gaps
        self.ar_order = ar_order
        self.ar_context = ar_context
        self.init_fn, self.step_fn = make_gan_adapt_step(cfg, lr=lr, n_gaps=n_gaps)

    def adapt(self, generator: torch.nn.Module, audio: torch.Tensor, gap_start: int, gap_len: int,
              seed: int = 0) -> Tuple[torch.nn.Module, Dict]:
        """Adapt to one clip ``audio (S,)`` (on the generator's device; the
        gap is zeroed here) and return ``(generator, info)``: the probe-best
        generator, ``generator`` itself when step 0 scored best, else a new
        module; ``generator`` is never written to.  ``info`` as JAX's:
        ``best_step``, ``best_probe_sdr``, ``probe_trajectory`` and
        ``probe_starts``."""
        sr = self.cfg.data.sample_rate
        n = int(audio.shape[-1])
        gap_start, gap_len = int(gap_start), int(gap_len)
        device = audio.device
        gs = torch.full((1,), gap_start, dtype=torch.int64, device=device)
        gl = torch.full((1,), gap_len, dtype=torch.int64, device=device)
        tmask = gap_mask(n, gs, gl, dtype=audio.dtype)
        max_gap = 1 << (gap_len - 1).bit_length()
        pseudo_clean = arinpaint(audio[None] * tmask, tmask, gs, gl, order=self.ar_order,
                                 context=self.ar_context, max_gap=max_gap)[0]

        probe_starts = probe_positions_for(n, gap_start, gap_len, sr, n_probes=self.n_probes)
        p = len(probe_starts)
        probe_audio = pseudo_clean[None].expand(p, n).contiguous()
        pgs = torch.as_tensor(probe_starts, dtype=torch.int64).to(device)
        pgl = torch.full((p,), gap_len, dtype=torch.int64, device=device)
        probe_gap = 1.0 - gap_mask(n, pgs, pgl, dtype=audio.dtype)

        def probe_score(model: torch.nn.Module) -> float:
            restored = self.inpaint_factory(model)(probe_audio, pgs, pgl)[0]
            return float(torch.mean(gap_sdr(probe_audio, restored, probe_gap)))

        work = copy.deepcopy(generator)
        optimizer = self.init_fn(work)
        train_audio = pseudo_clean[None].expand(self.batch, n).contiguous()
        draws = torch.Generator(device=device).manual_seed(seed)

        best = {"step": 0, "score": probe_score(generator)}
        best_state = None
        trajectory = [(0, best["score"])]
        for i in range(1, self.steps + 1):
            self.step_fn(work, optimizer, train_audio,
                         *draw_adapt_gaps(draws, self.cfg, self.batch, n, self.n_gaps))
            if i % self.probe_every == 0 or i == self.steps:
                s = probe_score(work)
                trajectory.append((i, s))
                if s > best["score"]:
                    best = {"step": i, "score": s}
                    best_state = {k: v.detach().clone() for k, v in work.state_dict().items()}
        del work, optimizer
        if best_state is None:
            best_gen = generator
        else:
            best_gen = copy.deepcopy(generator)
            best_gen.load_state_dict(best_state)
        info = {
            "best_step": best["step"],
            "best_probe_sdr": round(best["score"], 3),
            "probe_trajectory": [(int(s), round(v, 3)) for s, v in trajectory],
            "probe_starts": [int(s) for s in probe_starts],
        }
        return best_gen, info


def adapt_gan_variables(
    cfg: Config,
    generator: torch.nn.Module,
    inpaint_factory: Callable,
    audio: torch.Tensor,
    gap_start: int,
    gap_len: int,
    *,
    steps: int = 200,
    lr: float = 5e-5,
    batch: int = 8,
    probe_every: int = 25,
    n_probes: int = 4,
    n_gaps: int = 4,
    seed: int = 0,
    ar_order: int = 512,
    ar_context: int = 4096,
) -> Tuple[torch.nn.Module, Dict]:
    """One clip through a fresh :class:`GanClipAdapter` (the generator
    carries its own weights, where JAX's function takes its variables)."""
    adapter = GanClipAdapter(cfg, inpaint_factory, steps=steps, lr=lr, batch=batch,
                             probe_every=probe_every, n_probes=n_probes, n_gaps=n_gaps,
                             ar_order=ar_order, ar_context=ar_context)
    return adapter.adapt(generator, audio, gap_start, gap_len, seed=seed)

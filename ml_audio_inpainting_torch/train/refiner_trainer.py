"""Training and serving of the gap refiner (port of
``ml_audio_inpainting_tpu/train/refiner_trainer.py``).

The head (``models/refiner.py::WaveRefiner``) rides on two frozen
deployable solvers: the GAN under the extrapolated phase and the AR
extrapolation fill.  A train step corrupts a batch with one gap a clip,
runs both solvers, crops a :data:`WINDOW` around the gap, and takes the
head's gradient of the per-clip ``log(gap error energy / gap reference
energy)``, the negative of gap SDR up to 10/ln 10.  A fresh head is the AR
fill, so step 0 scores the AR baseline.

What differs from the JAX step, and why:

* The step takes its gap draws as inputs: ``gap_len`` ``(B,)`` and the
  ``K`` candidate starts ``(B, K)`` (:func:`draw_refiner_gaps` makes them on
  the device from a ``torch.Generator``; JAX draws them from a key inside
  its step, a stream a ``torch.Generator`` cannot reproduce).  The tests
  feed JAX's draws to the port.
* The crops and the paste are gathers and scatters on index tensors
  (``lax.dynamic_slice`` and ``dynamic_update_slice`` there): no host sync.
* The head is a module updated in place by ``torch.optim.Adam`` (optax's
  ``adam`` rule), not a pure function of a train state; the apply function
  takes the head module where JAX's takes its variables.
* The energy gate's median is the mean of the two middle order statistics,
  as ``jnp.median`` computes it (``torch.median`` returns the lower one).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ml_audio_inpainting_torch.classical._slices import clamped_window
from ml_audio_inpainting_torch.classical.arinpaint import arinpaint
from ml_audio_inpainting_torch.models.refiner import WaveRefiner, window_bounds
from ml_audio_inpainting_torch.ops.gaps import gap_mask
from ml_audio_inpainting_torch.runtime.inference import make_gan_inpaint_fn
from ml_audio_inpainting_torch.utils.config import Config
from ml_audio_inpainting_torch.utils.precision import full_f32_convolutions
from ml_audio_inpainting_torch.weights import refiner_channels, refiner_state_dict

__all__ = [
    "WINDOW",
    "MAX_GAP",
    "RefinerState",
    "create_refiner_state",
    "load_refiner",
    "make_example_fn",
    "draw_refiner_gaps",
    "make_refiner_train_step",
    "make_refiner_probe_fn",
    "make_refiner_apply_fn",
]

#: window around the gap fed to the head (1024 context samples a side)
WINDOW = 4096
#: static gap-length bound inside the window (128 ms at 16 kHz)
MAX_GAP = 2048
#: clip margin kept clear of training gaps, so the AR context lies inside
MARGIN = 8192
#: the solvers' channels are clipped to this after ``nan_to_num``
CHANNEL_CLIP = 4.0
ADAM_EPS = 1e-8  # optax.adam's default


@dataclass
class RefinerState:
    """The head, its Adam optimizer and the step count."""

    model: WaveRefiner
    optimizer: torch.optim.Adam
    step: int = 0


def create_refiner_state(
    generator: Optional[torch.Generator] = None,
    lr: float = 3e-4,
    channels: int = 64,
    device="cuda",
    params: Optional[Mapping[str, np.ndarray]] = None,
) -> RefinerState:
    """A head of ``channels`` on ``device`` with ``optax.adam(lr)``'s
    optimizer: from flat flax variables ``params`` (loaded strictly), else
    drawn from ``generator`` (a ``torch.Generator`` seeded 0 if None) by
    :meth:`WaveRefiner.init_weights`."""
    model = WaveRefiner(channels=channels)
    if params is not None:
        model.load_state_dict(refiner_state_dict(params))
    else:
        model.init_weights(generator if generator is not None else torch.Generator().manual_seed(0))
    model = model.to(device)
    return RefinerState(model, torch.optim.Adam(model.parameters(), lr=lr, eps=ADAM_EPS))


def load_refiner(flat: Mapping[str, np.ndarray], device="cuda") -> WaveRefiner:
    """The head of flat flax variables (e.g. an exported npz), its width
    read off ``Conv_0``, on ``device`` in eval mode."""
    model = WaveRefiner(channels=refiner_channels(flat))
    model.load_state_dict(refiner_state_dict(flat))
    return model.to(device).eval()


def make_example_fn(cfg: Config, gan_generator: torch.nn.Module, ar_order: int = 512,
                    ar_context: int = 4096) -> Callable:
    """``examples(audio (B, S), gap_start (B,), gap_len (B,)) -> dict`` of
    the head's inputs and target, each cropped to :data:`WINDOW` around the
    gap: ``impaired``, ``ar``, ``neural``, ``gap_ind``, ``clean`` ``(B,
    WINDOW)`` and the crops' ``start`` ``(B,)``.

    The neural channel is the GAN's deployable path (``enhanced``,
    ``extrapolate``), the AR channel the batched ``arinpaint`` (``order``
    ``ar_order``, ``context`` ``ar_context``, ``max_gap`` :data:`MAX_GAP`).
    Both pass through ``nan_to_num`` and a clip to +-4: an f32 LPC fit on a
    near-silent context can blow up, and one blown fill must not NaN a step.
    Runs without autograd; the GAN's convolutions in full f32.
    """
    inpaint_fn = make_gan_inpaint_fn(cfg, gan_generator, mode="enhanced", phase="extrapolate")

    @torch.no_grad()
    def examples(audio: torch.Tensor, gap_start: torch.Tensor,
                 gap_len: torch.Tensor) -> Dict[str, torch.Tensor]:
        n = audio.shape[-1]
        tmask = gap_mask(n, gap_start, gap_len, dtype=audio.dtype)
        impaired = audio * tmask
        with full_f32_convolutions():
            neural = inpaint_fn(audio, gap_start, gap_len)[0]
        fill = arinpaint(impaired, tmask, gap_start, gap_len, order=ar_order, context=ar_context,
                         max_gap=MAX_GAP)
        fill = torch.clamp(torch.nan_to_num(fill), -CHANNEL_CLIP, CHANNEL_CLIP)
        neural = torch.clamp(torch.nan_to_num(neural), -CHANNEL_CLIP, CHANNEL_CLIP)
        start, off = window_bounds(gap_start, gap_len, WINDOW, MAX_GAP, n)
        idx = torch.arange(WINDOW, device=audio.device)
        gap_ind = ((idx >= off[:, None]) & (idx < (off + gap_len)[:, None])).to(audio.dtype)
        return {
            "impaired": clamped_window(impaired, start, WINDOW),
            "ar": clamped_window(fill, start, WINDOW),
            "neural": clamped_window(neural, start, WINDOW),
            "gap_ind": gap_ind,
            "clean": clamped_window(audio, start, WINDOW),
            "start": start,
        }

    return examples


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: the two middle order statistics'
    sum times 0.5 (they are one value for an odd length)."""
    s = torch.sort(x).values
    n = x.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _gap_loss(out: torch.Tensor, clean: torch.Tensor, gap_ind: torch.Tensor,
              energy_gate: bool = False) -> torch.Tensor:
    """Mean over clips of ``log((err + 1e-9) / (ref + 1e-9))`` over the gap;
    with ``energy_gate`` each clip's term weighted by ``ref / (ref +
    median(ref))``, which mutes near-silent gaps."""
    err = torch.sum((out - clean) ** 2 * gap_ind, dim=-1)
    ref = torch.sum(clean**2 * gap_ind, dim=-1)
    li = torch.log((err + 1e-9) / (ref + 1e-9))
    if not energy_gate:
        return torch.mean(li)
    w = ref / (ref + _median(ref) + 1e-12)
    return torch.sum(w * li) / (torch.sum(w) + 1e-12)


def _gap_len_bounds(cfg: Config, gap_len_range: Tuple[float, float]) -> Tuple[int, int]:
    sr = cfg.data.sample_rate
    return int(gap_len_range[0] * sr), min(int(gap_len_range[1] * sr), MAX_GAP)


def draw_refiner_gaps(
    generator: torch.Generator,
    cfg: Config,
    batch: int,
    n_samples: int,
    gap_len_range: Tuple[float, float] = (0.04, 0.128),
    energy_cands: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(gap_len (B,), candidates (B, K))``, int64 on ``generator``'s
    device, as the JAX step draws them: lengths uniform over ``[lo, hi]``
    (``gap_len_range`` in seconds, ``hi`` at most :data:`MAX_GAP`) and ``K =
    energy_cands`` starts uniform over ``[MARGIN, S - MARGIN - hi)``."""
    lo, hi = _gap_len_bounds(cfg, gap_len_range)
    k = max(int(energy_cands), 1)
    device = generator.device
    gl = torch.randint(lo, hi + 1, (batch,), generator=generator, device=device)
    cands = torch.randint(MARGIN, n_samples - MARGIN - hi, (batch, k), generator=generator,
                          device=device)
    return gl, cands


def make_refiner_train_step(
    cfg: Config,
    gan_generator: torch.nn.Module,
    delta_penalty: float = 0.0,
) -> Callable:
    """``step(state, audio, gap_len, candidates) -> (state, metrics)``: the
    fused corrupt -> solve -> refine -> Adam step.

    ``audio`` is ``(B, S)`` f32 on the head's device; ``gap_len`` ``(B,)``
    and ``candidates`` ``(B, K)`` are :func:`draw_refiner_gaps`'s draws.
    Each clip's gap starts at the candidate with the most clean energy
    inside it (an f32 cumulative sum over the clip, as JAX's); voiced gaps
    keep the scale-invariant loss from being drowned by silence.
    ``delta_penalty`` adds ``lambda * mean(gap delta energy / gap reference
    energy)``, a bias toward the AR fill.  ``metrics`` holds ``loss`` and
    the AR fill's own loss ``ar_baseline``, 0-d device tensors (no host
    sync in the step).  The head trains in f32, its convolutions in full
    f32.
    """
    examples = make_example_fn(cfg, gan_generator)

    def step(state: RefinerState, audio: torch.Tensor, gap_len: torch.Tensor,
             candidates: torch.Tensor) -> Tuple[RefinerState, Dict[str, torch.Tensor]]:
        csum = torch.cumsum(audio**2, dim=-1)
        energy = csum.gather(-1, candidates + gap_len[:, None]) - csum.gather(-1, candidates)
        gap_start = candidates.gather(-1, energy.argmax(-1, keepdim=True))[:, 0]
        ex = examples(audio, gap_start, gap_len)
        with full_f32_convolutions():
            out = state.model(ex["impaired"], ex["ar"], ex["neural"], ex["gap_ind"])
            loss = _gap_loss(out, ex["clean"], ex["gap_ind"], energy_gate=True)
            if delta_penalty > 0.0:
                d2 = torch.sum((out - ex["ar"]) ** 2 * ex["gap_ind"], dim=-1)
                ref = torch.sum(ex["clean"] ** 2 * ex["gap_ind"], dim=-1)
                loss = loss + delta_penalty * torch.mean(d2 / (ref + 1e-9))
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            base = _gap_loss(ex["ar"], ex["clean"], ex["gap_ind"], energy_gate=True)
        return state, {"loss": loss.detach(), "ar_baseline": base}

    return step


def _sdr(x: torch.Tensor, clean: torch.Tensor, gap_ind: torch.Tensor) -> torch.Tensor:
    err = torch.sum((x - clean) ** 2 * gap_ind, dim=-1)
    ref = torch.sum(clean**2 * gap_ind, dim=-1)
    return torch.mean(10.0 * torch.log10(ref / (err + 1e-12)))


def make_refiner_probe_fn(cfg: Config, gan_generator: torch.nn.Module) -> Callable:
    """``probe(head, clips, gap_starts=None) -> (refined, ar)``: the mean gap
    SDR (dB, 0-d device tensors) of the head and of the AR fill under the
    evaluation contract, one 80 ms gap a clip at 2.0 s or at ``gap_starts``
    (``(B,)`` samples; the real-clip probe set repeats each clip at several
    positions).  JAX's takes the train state; this the head module."""
    examples = make_example_fn(cfg, gan_generator)
    sr = cfg.data.sample_rate

    @torch.inference_mode()
    def probe(head: WaveRefiner, clips: torch.Tensor,
              gap_starts=None) -> Tuple[torch.Tensor, torch.Tensor]:
        b = clips.shape[0]
        if gap_starts is None:
            gs = torch.full((b,), int(2.0 * sr), dtype=torch.int64, device=clips.device)
        else:
            gs = torch.as_tensor(gap_starts, dtype=torch.int64, device=clips.device)
        gl = torch.full((b,), int(0.08 * sr), dtype=torch.int64, device=clips.device)
        ex = examples(clips, gs, gl)
        with full_f32_convolutions():
            out = head(ex["impaired"], ex["ar"], ex["neural"], ex["gap_ind"])
        return _sdr(out, ex["clean"], ex["gap_ind"]), _sdr(ex["ar"], ex["clean"], ex["gap_ind"])

    return probe


def make_refiner_apply_fn(cfg: Config, gan_generator: torch.nn.Module) -> Callable:
    """``fn(head, audio, gap_start, gap_len) -> restored (B, S)``: serving.
    The refined window is written back over the gapped clip at its crop
    start, and the clip's samples outside the gap are the input's, bit for
    bit.  ``head`` is a :class:`WaveRefiner` (JAX's function takes its
    variables; the head's width comes with the module)."""
    examples = make_example_fn(cfg, gan_generator)

    @torch.inference_mode()
    def fn(head: WaveRefiner, audio: torch.Tensor, gap_start: torch.Tensor,
           gap_len: torch.Tensor) -> torch.Tensor:
        ex = examples(audio, gap_start, gap_len)
        with full_f32_convolutions():
            out = head(ex["impaired"], ex["ar"], ex["neural"], ex["gap_ind"])
        tmask = gap_mask(audio.shape[-1], gap_start, gap_len, dtype=audio.dtype)
        idx = ex["start"][:, None] + torch.arange(WINDOW, device=audio.device)
        pasted = (audio * tmask).scatter(-1, idx, out)
        return audio * tmask + pasted * (1.0 - tmask)

    return fn

"""Training CLI of the port (port of ``ml_audio_inpainting_tpu/cli/train.py``)::

    python -m ml_audio_inpainting_torch.cli.train --model cnn_blstm \\
        --config configs/cnn_blstm_b128.yaml --train-dtype bf16 --train-n-gaps 3 \\
        --synthetic 2000 --corpus formant_v2 --feed device --ema 0.999 \\
        --probe-every 500 [--device cpu]
    python -m ml_audio_inpainting_torch.cli.train --model gan --config configs/gan.yaml \\
        --batch-size 32 --train-dtype bf16 --train-n-gaps 4 --synthetic 2000 --ema 0.999

Both families, with every flag of the JAX CLI and the same meaning, and
``--device`` (``cuda`` unless the caller asks for ``cpu``): a config (YAML,
or JSON, which needs no YAML package), a synthetic corpus (``--synthetic
N --corpus ...``) or a directory tree of files, a feed (``stream``: decode
and upload each batch, or ``device``: the whole corpus on the device once),
the train step (``train/cnn_trainer.py``, ``train/gan_trainer.py``; bf16
with ``--train-dtype bf16``, the EMA with ``--ema``, the phase-mode CNN with
``--phase-mode [--phase-anchor]``, the GAN's ``--remat``), and at their
intervals: the loss logged (the only host sync of a step between the
intervals), validation, the held-out gap-SDR probe with patience and the
best checkpoint, sample dumps (GAN, FLAC through the port's codec), and
checkpoints of the whole state every ``logging.checkpoint_interval``
epochs (``train/checkpoints.py::CheckpointManager``).  ``--resume``
continues this run's directory, ``--resume-from DIR`` another run's
latest step; as in JAX, the random stream restarts from ``--seed``, so a
resumed run does not replay an uninterrupted run's data order.  At the end
the probe-best weights (the EMA where on) are exported as
``checkpoints/<run>/best_inference.npz``, which ``cli/inpaint.py`` and
``cli/evaluate.py`` serve (and the JAX package's ``load_params_npz``
reads).

The port's steps take gap positions, not a key: they are drawn on the
device from a ``torch.Generator`` seeded ``--seed`` (``jax.random`` draws
others from the same seed).  ``--feed auto`` sizes the device feed from
the card's free memory (``torch.cuda.mem_get_info``) and the port's own
measured step peaks (:data:`STEP_PEAK_BYTES`).  ``--model-parallel > 1``
raises ``SystemExit`` naming its ROADMAP item.

:func:`main` returns what it did (:class:`TrainResult`) for callers that
drive it in-process; ``on_step(step)``, if given, is called after each
step's launch.
"""

from __future__ import annotations

import argparse
import functools
import math
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["build_argparser", "main", "make_dataset", "GapDraws", "TrainResult",
           "STEP_PEAK_BYTES", "feed_choice"]

# Peak device memory of one train step a sequence (a clip x gap variant), as
# the port's steps measured it on one H100 80GB HBM3 (PERF.md section 5):
# the CNN+BiLSTM production recipe in bf16, 29.3 GB at 128 sequences
# (chip_smoke.py phase training_bf16); the GAN in bf16, 15.5 GB at B=32, and in
# f32, 28.9 GB at B=8 (scripts/torch_gan_training_profile.py).  The
# CNN+BiLSTM in f32 was not measured: twice its bf16 figure (f32 activations).
STEP_PEAK_BYTES = {
    ("cnn_blstm", "bf16"): 29.3e9 / 128,
    ("cnn_blstm", "f32"): 2 * 29.3e9 / 128,
    ("gan", "bf16"): 15.5e9 / 32,
    ("gan", "f32"): 28.9e9 / 8,
}
DEVICE_FEED_MAX_BYTES = 2 * 1024**3  # the JAX CLI's cap on a device-resident corpus
FEED_MARGIN_BYTES = 2 * 1024**3  # kept free beside the step's estimate
ROADMAP_MODEL_PARALLEL = "ROADMAP Queue A item 8 (multi-device training)"


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train an audio-inpainting model")
    p.add_argument("--model", choices=["gan", "cnn_blstm"], required=True)
    p.add_argument("--config", type=str, default=None, help="YAML (or JSON) config path")
    p.add_argument("--data-root", type=str, default=None, help="override data.root_path")
    p.add_argument("--synthetic", type=int, default=0, help="use N synthetic clips instead of files")
    p.add_argument("--corpus", choices=["formant", "formant_v2", "formant_v3", "harmonic"],
                   default="formant",
                   help="synthetic corpus style: formant-synthesised pseudo-speech (default), "
                        "its richer v2/v3 variants, or the simple harmonic stack")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--steps", type=int, default=None, help="hard cap on total steps")
    p.add_argument("--run-name", type=str, default=None)
    p.add_argument("--base-dir", type=str, default=".")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="devices a model is split over (1 only: " + ROADMAP_MODEL_PARALLEL + ")")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--resume-from", type=str, default=None,
                   help="checkpoint directory of a prior run to restore the latest step from; "
                        "training continues into this run's own directory. Pass the same "
                        "--ema/--phase-mode the prior run used so the state matches")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--valid-every", type=int, default=0,
                   help="run a validation pass every N steps (0 = off)")
    p.add_argument("--valid-batches", type=int, default=4)
    p.add_argument("--workers", type=int, default=4, help="host decode threads")
    p.add_argument("--feed", choices=["auto", "stream", "device"], default="auto",
                   help="input pipeline: 'stream' decodes and uploads each batch (bounded "
                        "prefetch); 'device' uploads the whole corpus once and gathers batches "
                        "there; 'auto' picks 'device' when the corpus is at most 2 GiB f32 and "
                        "fits beside the step's measured peak in the device's free memory. "
                        "Both give the same epoch order")
    p.add_argument("--train-n-gaps", type=int, default=None,
                   help="train with N spacing-constrained gaps a clip instead of one")
    p.add_argument("--train-gap-len", type=float, default=None,
                   help="override data.gap_len_s for the training corruption")
    p.add_argument("--probe-every", type=int, default=0,
                   help="score a held-out gap-SDR probe every N steps and keep the best "
                        "checkpoint under checkpoints/<run>/best (0 = off)")
    p.add_argument("--probe-clips", type=int, default=8,
                   help="number of held-out clips in the probe batch")
    p.add_argument("--probe-dir", type=str, default=None,
                   help="directory of real held-out probe clips (overrides the synthetic "
                        "probe source); each is probed at --probe-positions")
    p.add_argument("--probe-positions", type=float, nargs="+", default=[2.0],
                   help="gap start times (s) per probe clip when --probe-dir is set")
    p.add_argument("--probe-gap-len", type=float, default=0.08,
                   help="gap length (s) of the held-out probe condition")
    p.add_argument("--probe-patience", type=int, default=0,
                   help="stop after P consecutive probes without a new best (0 = never)")
    p.add_argument("--train-dtype", choices=["f32", "bf16"], default="f32",
                   help="compute precision of the step: bf16 runs the networks in bfloat16 "
                        "with f32 master weights and f32 losses")
    p.add_argument("--ema", "--g-ema", dest="ema", type=float, default=0.0,
                   help="serving-side parameter EMA decay (0 = off); the probe, the best "
                        "checkpoint's selection and the exported npz use the EMA weights")
    p.add_argument("--phase-mode", action="store_true",
                   help="cnn_blstm only: train the complex 2-channel pipeline (real and "
                        "imaginary STFT channels in, complex L1 on the gap out)")
    p.add_argument("--phase-anchor", action="store_true",
                   help="with --phase-mode: rotate the complex target by the deployable "
                        "phase-vocoder anchor; serve with --model cnn_phase_anchored")
    p.add_argument("--remat", action="store_true",
                   help="recompute the GAN step's network activations in the backward "
                        "instead of holding them")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def _synthetic_cls(args):
    from ml_audio_inpainting_torch.data.dataset import FormantSpeechDataset, SyntheticSpeechDataset

    if args.corpus == "harmonic":
        return SyntheticSpeechDataset
    if args.corpus in ("formant_v2", "formant_v3"):
        return functools.partial(FormantSpeechDataset, variant=args.corpus.split("_")[1])
    return FormantSpeechDataset


def make_dataset(cfg, args):
    """The training corpus: ``--synthetic`` clips, or the files under
    ``data.root_path/data.train_path``."""
    from ml_audio_inpainting_torch.data.dataset import AudioFileDataset

    if args.synthetic:
        return _synthetic_cls(args)(n_items=args.synthetic, sample_rate=cfg.data.sample_rate,
                                    max_len_s=cfg.data.max_len_s)
    root = Path(args.data_root or cfg.data.root_path) / cfg.data.train_path
    return AudioFileDataset(root, sample_rate=cfg.data.sample_rate, max_len_s=cfg.data.max_len_s,
                            max_files=cfg.data.train_limit or cfg.data.n_files)


def _file_dataset(cfg, args, n_files: int):
    """The valid split's files, or None where it does not exist."""
    from ml_audio_inpainting_torch.data.dataset import AudioFileDataset

    root = Path(args.data_root or cfg.data.root_path) / cfg.data.valid_path
    if not root.exists():
        return None
    return AudioFileDataset(root, sample_rate=cfg.data.sample_rate, max_len_s=cfg.data.max_len_s,
                            max_files=n_files)


def _items(dataset, n: int, workers: int) -> np.ndarray:
    """``(n, S)`` f32: the first ``n`` items, decoded on ``workers`` threads."""
    with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
        return np.stack(list(ex.map(dataset.__getitem__, range(n)))).astype(np.float32)


class GapDraws:
    """The train steps' gap positions, drawn on ``device`` from a
    ``torch.Generator`` seeded ``seed`` as the JAX step's features draw
    theirs from a key (no host sync): one gap a variant uniform over
    ``[0, S - L]`` (``ops/gaps.py::random_gap_mask``), or with
    ``cfg.data.train_n_gaps`` K > 1 the ``multi_gap_mask`` layout of
    uniforms (``data/multigap.py``)."""

    def __init__(self, cfg, device, seed: int):
        self.cfg = cfg
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _starts(self, shape) -> torch.Tensor:
        d = self.cfg.data
        n, length = d.max_samples, int(d.gap_len_s * d.sample_rate)
        if length <= 0 or length >= n:  # no gap, or the whole clip: start 0
            return torch.zeros(shape, dtype=torch.int64, device=self.device)
        return torch.randint(0, n - length + 1, shape, generator=self.generator,
                             device=self.device)

    def _layout(self, shape) -> Tuple[torch.Tensor, torch.Tensor]:
        from ml_audio_inpainting_torch.data.multigap import multi_gap_layout

        d = self.cfg.data
        full = (*shape, d.train_n_gaps)
        u_len = torch.rand(full, generator=self.generator, device=self.device)
        u_pos = torch.rand(full, generator=self.generator, device=self.device)
        starts, lengths = multi_gap_layout(u_len, u_pos, d.max_samples,
                                           max_gap_ms=d.gap_len_s * 1000.0,
                                           sample_rate=d.sample_rate)
        return starts.to(torch.int64), lengths.to(torch.int64)

    def cnn(self, clips: int) -> tuple:
        """``(gap_start,)`` ``(B, G)``, or ``(gap_start, gap_len)`` ``(B, G, K)``."""
        shape = (clips, self.cfg.data.gaps_per_audio)
        return (self._starts(shape),) if self.cfg.data.train_n_gaps == 1 else self._layout(shape)

    def gan(self, clips: int) -> tuple:
        """``(gap_start,)`` ``(B,)``, or ``(gap_start, gap_len)`` ``(B, K)``."""
        return (self._starts((clips,)),) if self.cfg.data.train_n_gaps == 1 else self._layout(
            (clips,))


def feed_choice(model: str, train_dtype: str, sequences: int, corpus_bytes: int,
                device) -> Tuple[str, str]:
    """``(feed, reason)`` of ``--feed auto``: ``device`` when the corpus is
    at most 2 GiB and, on a card, fits in its free memory beside the step's
    estimated peak (``sequences`` x :data:`STEP_PEAK_BYTES`) and a 2 GiB
    margin; else ``stream``."""
    device = torch.device(device)
    if device.type != "cuda":
        ok = corpus_bytes <= DEVICE_FEED_MAX_BYTES
        return ("device" if ok else "stream",
                f"corpus ~{corpus_bytes / 2**20:.0f} MiB f32 in host memory")
    free, _ = torch.cuda.mem_get_info(device)
    step = STEP_PEAK_BYTES[(model, train_dtype)] * sequences
    headroom = free - step - FEED_MARGIN_BYTES
    ok = corpus_bytes <= min(DEVICE_FEED_MAX_BYTES, headroom)
    return ("device" if ok else "stream",
            f"corpus ~{corpus_bytes / 2**20:.0f} MiB f32, step peak est ~{step / 2**30:.1f} "
            f"GiB ({train_dtype}, {sequences} sequences), free {free / 2**30:.1f} GiB")


@dataclass
class TrainResult:
    """What :func:`main` did: the final states (``state`` for the CNN+BiLSTM,
    ``{"g", "d"}`` for the GAN), the last step, the run's checkpoint
    directory, the probe's best step (-1 without one) and gap SDR, the
    exported ``best_inference.npz`` (or None), and the logs of losses
    (``(step, {name: value})`` at each loss log), intervals (``(from_step,
    to_step, seconds)`` between loss logs, the device synchronised at both
    ends), saves (``(step, seconds, bytes)``), probes (``(step, gap SDR dB,
    PSM, seconds)``) and sample files."""

    model: str
    state: Any
    step: int
    run_name: str
    checkpoint_dir: Path
    sample_dir: Path
    best_step: int = -1
    best_sdr: float = -math.inf
    best_npz: Optional[Path] = None
    feed: str = ""
    losses: List[Tuple[int, dict]] = field(default_factory=list)
    intervals: List[Tuple[int, int, float]] = field(default_factory=list)
    saves: List[Tuple[int, float, int]] = field(default_factory=list)
    probes: List[Tuple[int, float, float, float]] = field(default_factory=list)
    samples: List[Path] = field(default_factory=list)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, on_step: Optional[Callable[[int], None]] = None) -> TrainResult:
    from ml_audio_inpainting_torch.data.pipeline import (
        batch_iterator,
        device_corpus_feed,
        prefetch_to_device,
    )
    from ml_audio_inpainting_torch.ops.gaps import gap_mask
    from ml_audio_inpainting_torch.train.checkpoints import CheckpointManager, export_params_npz
    from ml_audio_inpainting_torch.utils.config import Config, load_config
    from ml_audio_inpainting_torch.utils.precision import full_f32_convolutions
    from ml_audio_inpainting_torch.utils.run_logging import RunContext

    args = build_argparser().parse_args(argv)
    if args.model_parallel != 1:
        raise SystemExit(f"--model-parallel {args.model_parallel}: the port trains on one "
                         f"device; multi-device training is {ROADMAP_MODEL_PARALLEL}")
    if args.model != "gan" and args.remat:
        raise SystemExit("--remat is supported for --model gan only")
    if args.phase_mode and args.model != "cnn_blstm":
        raise SystemExit("--phase-mode is supported for --model cnn_blstm only")
    if args.phase_anchor and not args.phase_mode:
        raise SystemExit("--phase-anchor requires --phase-mode")
    cfg = load_config(args.config) if args.config else Config()
    if args.phase_mode:
        cfg.model.cnn_blstm.in_channels = 2
        if cfg.data.train_n_gaps > 1:
            raise SystemExit("--phase-mode has no multi-gap training features "
                             "(cnn_phase_features is single-gap)")
    if args.epochs is not None:
        cfg.training.epochs = args.epochs
        cfg.training.max_n_epochs = args.epochs
    if args.batch_size is not None:
        cfg.training.batch_size = args.batch_size
    if args.train_n_gaps is not None:
        cfg.data.train_n_gaps = args.train_n_gaps
    if args.train_gap_len is not None:
        cfg.data.gap_len_s = args.train_gap_len
    if args.phase_mode and cfg.data.train_n_gaps > 1:
        raise SystemExit("--phase-mode has no multi-gap training features "
                         "(cnn_phase_features is single-gap)")

    device = torch.device(args.device)
    B = cfg.training.batch_size
    sr = cfg.data.sample_rate
    run = RunContext(cfg, run_name=args.run_name, base_dir=args.base_dir)
    run.logger.info("argv: %s", " ".join(argv if argv is not None else sys.argv[1:]))
    run.logger.info("device: %s", torch.cuda.get_device_name(device) if device.type == "cuda"
                    else device)

    dataset = make_dataset(cfg, args)
    run.logger.info("dataset: %d items", len(dataset))

    # Validation source: a held-out synthetic set, or the valid split's files.
    valid_dataset = None
    if args.valid_every:
        n_valid = args.valid_batches * B
        if args.synthetic:
            valid_dataset = _synthetic_cls(args)(n_items=n_valid, sample_rate=sr,
                                                 max_len_s=cfg.data.max_len_s, seed=999)
        else:
            valid_dataset = _file_dataset(cfg, args, n_valid)

    # The held-out probe: one gap of --probe-gap-len at 2.0 s a clip (or at
    # --probe-positions of real clips), scored by gap SDR, PSM logged beside.
    probe_clips = probe_dir_gs = None
    if args.probe_every and args.probe_dir:
        from ml_audio_inpainting_torch.data.probe import load_real_probe_set

        pclips, probe_dir_gs, n_pfiles = load_real_probe_set(
            args.probe_dir, args.probe_positions, sr, cfg.data.max_len_s,
            gap_len_s=args.probe_gap_len)
        probe_clips = torch.from_numpy(pclips).to(device)
        run.logger.info("real probe: %d clips x %d positions from %s", n_pfiles,
                        len(args.probe_positions), args.probe_dir)
    elif args.probe_every:
        if args.synthetic:
            probe_ds = _synthetic_cls(args)(n_items=args.probe_clips, sample_rate=sr,
                                            max_len_s=cfg.data.max_len_s, seed=4242)
        else:
            probe_ds = _file_dataset(cfg, args, args.probe_clips)
        if probe_ds is not None and len(probe_ds) > 0:
            k = min(args.probe_clips, len(probe_ds))
            probe_clips = torch.from_numpy(_items(probe_ds, k, args.workers)).to(device)
        else:
            run.logger.warning("--probe-every set but no probe source; disabled")

    best_ckpt = None
    result = TrainResult(args.model, None, 0, run.run_name, run.checkpoint_dir, run.sample_dir)
    probe_stale = [0]
    if probe_clips is not None:
        from ml_audio_inpainting_torch.train.auditory import psm_score
        from ml_audio_inpainting_torch.train.metrics import gap_sdr

        best_ckpt = CheckpointManager(run.checkpoint_dir / "best", save_interval_steps=1,
                                      max_to_keep=1)
        k, n = probe_clips.shape
        gl = int(args.probe_gap_len * sr)
        if gl > n // 2:
            gl = n // 2
            run.logger.warning("probe gap %.3fs exceeds half the %.3fs clip; clamped to %.3fs",
                               args.probe_gap_len, n / sr, gl / sr)
        gs = int(2.0 * sr)
        if gs + gl >= n:  # a clip shorter than the evaluation condition
            gs = max(0, (n - gl) // 2)
        if probe_dir_gs is not None:
            probe_gs = torch.from_numpy(np.clip(probe_dir_gs, 0, n - gl - 1).astype(np.int64))
        else:
            probe_gs = torch.full((k,), gs, dtype=torch.int64)
        probe_gs = probe_gs.to(device)
        probe_gl = torch.full((k,), gl, dtype=torch.int64, device=device)
        probe_gap = 1.0 - gap_mask(n, probe_gs, probe_gl)

        def run_probe(step: int, inpaint_fn, payload) -> bool:
            """Score the probe; keep a new best.  True when patience is spent."""
            t0 = time.perf_counter()
            with full_f32_convolutions():
                restored, _ = inpaint_fn(probe_clips, probe_gs, probe_gl)
            sdr = gap_sdr(probe_clips, restored, probe_gap).mean().item()
            psm = psm_score(probe_clips, restored).mean().item()
            result.probes.append((step, sdr, psm, time.perf_counter() - t0))
            run.scalar("Probe/gap_sdr_db", sdr, step)
            run.scalar("Probe/psm", psm, step)
            if sdr > result.best_sdr + 1e-6:
                result.best_sdr, result.best_step = sdr, step
                probe_stale[0] = 0
                best_ckpt.save(step, payload, force=True)
                run.logger.info("probe @ step %d: gap-SDR %.2f dB, PSM %.3f (new best)",
                                step, sdr, psm)
                return False
            probe_stale[0] += 1
            run.logger.info("probe @ step %d: gap-SDR %.2f dB, PSM %.3f (best %.2f @ %d, "
                            "stale %d)", step, sdr, psm, result.best_sdr, result.best_step,
                            probe_stale[0])
            return bool(args.probe_patience and probe_stale[0] >= args.probe_patience)

    epochs = cfg.training.epochs if args.model == "gan" else cfg.training.max_n_epochs
    feed_mode = args.feed
    if feed_mode == "auto":
        sequences = B * (cfg.data.gaps_per_audio if args.model == "cnn_blstm" else 1)
        feed_mode, why = feed_choice(args.model, args.train_dtype, sequences,
                                     len(dataset) * cfg.data.max_samples * 4, device)
        run.logger.info("feed auto -> %s (%s)", feed_mode, why)
    result.feed = feed_mode
    if feed_mode == "device":
        feed = device_corpus_feed(dataset, B, shuffle=True, seed=args.seed, epochs=epochs,
                                  device=device, workers=args.workers, log=run.logger.info)
    else:
        feed = prefetch_to_device(
            batch_iterator(dataset, B, shuffle=True, seed=args.seed, epochs=epochs,
                           workers=args.workers), size=2, device=device)

    ckpt = CheckpointManager(run.checkpoint_dir, save_interval_steps=1, max_to_keep=5)
    resume_src = ckpt if args.resume else None
    if args.resume_from:
        resume_src = CheckpointManager(args.resume_from, max_to_keep=None)
        if resume_src.latest_step() is None:
            raise SystemExit(f"--resume-from {args.resume_from}: no checkpoint found")
    draws = GapDraws(cfg, device, args.seed)
    steps_per_epoch = max(1, len(dataset) // B)
    ckpt_every = cfg.logging.checkpoint_interval * steps_per_epoch
    compute_dtype = torch.bfloat16 if args.train_dtype == "bf16" else None

    def save(manager, step: int, state, force: bool = False) -> None:
        t0 = time.perf_counter()
        if manager.save(step, state, force=force):
            path = manager.directory / str(step) / "state.pt"
            result.saves.append((step, time.perf_counter() - t0, path.stat().st_size))
            run.logger.info("checkpoint step %d: %.1f MB in %.2f s", step,
                            path.stat().st_size / 1e6, result.saves[-1][1])

    def validate(eval_fn, states: tuple, step: int, gap_draws: Callable) -> None:
        if valid_dataset is None:
            return
        vals = []
        for vb in batch_iterator(valid_dataset, B, shuffle=False, epochs=1):
            vb = torch.from_numpy(vb).to(device)
            # The same gap draws for every batch (JAX reuses PRNGKey(123)).
            out = eval_fn(*states, vb, *gap_draws(GapDraws(cfg, device, 123), vb.shape[0]))
            vals.append({k: float(v) for k, v in out.items()})
        if vals:
            means = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]}
            for k, v in means.items():
                run.scalar(f"Loss_Valid/{k}", v, step)
            run.logger.info("validation @ step %d: %s", step,
                            {k: round(v, 4) for k, v in means.items()})

    last = [0, 0.0]

    def interval(step: int) -> float:
        """Steps/s since the last log (the caller has just synchronised)."""
        now = time.perf_counter()
        result.intervals.append((last[0], step, now - last[1]))
        rate = (step - last[0]) / max(now - last[1], 1e-9)
        last[:] = [step, now]
        return rate

    if args.model == "cnn_blstm":
        from ml_audio_inpainting_torch.models.build import build_model
        from ml_audio_inpainting_torch.runtime.inference import (
            make_cnn_inpaint_fn,
            make_cnn_phase_inpaint_fn,
        )
        from ml_audio_inpainting_torch.train.cnn_trainer import (
            create_cnn_state,
            make_cnn_eval_step,
            make_cnn_train_step,
        )

        state = create_cnn_state(cfg, device=device, ema=args.ema, seed=args.seed)
        if resume_src is not None and resume_src.latest_step() is not None:
            resume_src.restore(state)
            run.logger.info("resumed from step %s", resume_src.latest_step())
        step_fn = make_cnn_train_step(cfg, ema=args.ema, compute_dtype=compute_dtype,
                                      phase_mode=args.phase_mode, phase_anchor=args.phase_anchor)
        eval_fn = (make_cnn_eval_step(cfg, phase_mode=args.phase_mode,
                                      phase_anchor=args.phase_anchor)
                   if args.valid_every else None)
        serve_model = probe_fn = None
        if probe_clips is not None:
            serve_model = build_model(cfg, device)
            probe_fn = (make_cnn_phase_inpaint_fn(cfg, serve_model, anchored=args.phase_anchor)
                        if args.phase_mode else make_cnn_inpaint_fn(cfg, serve_model))

        def cnn_probe(step: int) -> bool:
            # Serve the EMA weights when on (what deployment would use).
            serve_model.load_state_dict({**state.model.state_dict(), **(state.ema_params or {})})
            return run_probe(step, probe_fn, state)

        step = state.step
        _sync(device)
        last[:] = [step, time.perf_counter()]
        for audio in feed:
            state, metrics = step_fn(state, audio, *draws.cnn(audio.shape[0]))
            step += 1
            if on_step is not None:
                on_step(step)
            if step % cfg.logging.metric_interval == 0:
                loss = float(metrics["loss"])
                rate = interval(step)
                result.losses.append((step, {"loss": loss}))
                run.scalar("Loss_Train/L1_gap", loss, step)
                run.logger.info("step %d loss %.4f (%.2f steps/s)", step, loss, rate)
            if args.valid_every and step % args.valid_every == 0:
                validate(eval_fn, (state,), step, lambda g, b: g.cnn(b))
            if probe_fn is not None and step % args.probe_every == 0 and cnn_probe(step):
                run.logger.info("early stop at step %d (probe patience)", step)
                break
            if step % ckpt_every == 0:
                save(ckpt, step, state)
            if args.steps and step >= args.steps:
                break
        save(ckpt, step, state, force=True)
        result.state = state

    else:  # gan
        from ml_audio_inpainting_torch.data.audio_io import save_audio
        from ml_audio_inpainting_torch.models.build import build_generator
        from ml_audio_inpainting_torch.models.vgg import vgg19_params
        from ml_audio_inpainting_torch.runtime.inference import make_gan_inpaint_fn
        from ml_audio_inpainting_torch.train.gan_trainer import (
            create_gan_states,
            make_gan_eval_step,
            make_gan_train_step,
        )
        from ml_audio_inpainting_torch.utils.visualize import visualize_spectrogram

        g_state, d_state = create_gan_states(
            cfg, device=device, generator=torch.Generator().manual_seed(args.seed),
            g_ema=args.ema)
        use_vgg = cfg.training.lambda_vgg_perceptual > 0 or cfg.training.lambda_vgg_style > 0
        vgg = vgg19_params(device=device) if use_vgg else None
        step_fn = make_gan_train_step(cfg, vgg=vgg, compute_dtype=compute_dtype,
                                      remat=args.remat, g_ema=args.ema)
        if resume_src is not None and resume_src.latest_step() is not None:
            resume_src.restore({"g": g_state, "d": d_state})
            run.logger.info("resumed from step %s", resume_src.latest_step())

        # Sample dumps: the live generator's reconstruction of the first clip.
        sample_fn = make_gan_inpaint_fn(cfg, g_state.model, mode="parity")
        sample_clip = torch.from_numpy(np.asarray(dataset[0], np.float32))[None].to(device)
        sample_gap = (
            torch.tensor([int(2.0 * sr) % max(1, cfg.data.max_samples - 1)], device=device),
            torch.tensor([int(cfg.data.gap_len_s * sr)], device=device))
        spec = cfg.data.spectrogram

        def dump_samples(step: int) -> None:
            with full_f32_convolutions():
                restored, gen_spec = sample_fn(sample_clip, *sample_gap)
            wav = restored[0].cpu().numpy()
            path = run.sample_dir / f"sample_step{step:07d}.flac"
            save_audio(wav, path, sr)
            result.samples.append(path)
            run.audio("Samples/reconstruction", wav, step, sr)
            fig = visualize_spectrogram(gen_spec[0], hop_length=spec.hop_length,
                                        n_fft=spec.n_fft, win_length=spec.win_length,
                                        in_db=False, title=f"Generated (step {step})")
            if fig is not None:
                run.figure("Samples/generated_spectrogram", fig, step)
                import matplotlib.pyplot as plt

                plt.close(fig)

        gan_eval_fn = make_gan_eval_step(cfg, vgg=vgg) if args.valid_every else None
        serve_gen = gan_probe_fn = None
        if probe_clips is not None:
            # The production serving mode (the evaluation condition), not the sampler's.
            serve_gen = build_generator(cfg, device)
            gan_probe_fn = make_gan_inpaint_fn(cfg, serve_gen, mode="enhanced")

        def gan_probe(step: int) -> bool:
            serve_gen.load_state_dict({**g_state.model.state_dict(),
                                       **(g_state.ema_params or {})})
            return run_probe(step, gan_probe_fn, {"g": g_state, "d": d_state})

        step = g_state.step
        _sync(device)
        last[:] = [step, time.perf_counter()]
        for audio in feed:
            g_state, d_state, metrics = step_fn(g_state, d_state, audio,
                                                *draws.gan(audio.shape[0]))
            step += 1
            if on_step is not None:
                on_step(step)
            if step % cfg.logging.log_interval == 0:
                values = {k: float(v) for k, v in metrics.items()}
                rate = interval(step)
                result.losses.append((step, values))
                for tag, k in [
                    ("Loss_Train/Generator_Total", "g_total"),
                    ("Loss_Train/Discriminator", "d_total"),
                    ("Loss_Train/Generator_Adversarial", "g_adv"),
                    ("Loss_Train/Generator_L1_Valid", "g_l1_valid"),
                    ("Loss_Train/Generator_L1_Hole", "g_l1_hole"),
                    ("Loss_Train/Generator_MagWeighted", "g_mag_weighted"),
                    ("Loss_Train/Generator_VGG_Perceptual", "g_vgg_perceptual"),
                    ("Loss_Train/Generator_VGG_Style", "g_vgg_style"),
                    ("Loss_Train/Discriminator_Real", "d_real"),
                    ("Loss_Train/Discriminator_Fake", "d_fake"),
                ]:
                    run.scalar(tag, values[k], step)
                run.logger.info("step %d g_total %.4f d_total %.4f (%.2f steps/s)", step,
                                values["g_total"], values["d_total"], rate)
            if step % cfg.logging.sample_interval == 0:
                dump_samples(step)
            if args.valid_every and step % args.valid_every == 0:
                validate(gan_eval_fn, (g_state, d_state), step, lambda g, b: g.gan(b))
            if gan_probe_fn is not None and step % args.probe_every == 0 and gan_probe(step):
                run.logger.info("early stop at step %d (probe patience)", step)
                break
            if step % ckpt_every == 0:
                save(ckpt, step, {"g": g_state, "d": d_state})
            if args.steps and step >= args.steps:
                break
        save(ckpt, step, {"g": g_state, "d": d_state}, force=True)
        result.state = {"g": g_state, "d": d_state}

    result.step = step
    ckpt.wait()
    ckpt.close()
    if best_ckpt is not None:
        best_ckpt.wait()
        if result.best_step >= 0:
            run.logger.info("best probe checkpoint: step %d (gap-SDR %.2f dB) under %s",
                            result.best_step, result.best_sdr, best_ckpt.directory)
            # The deployable artifact: the probe-best inference weights (the EMA
            # where on, with the running statistics), no optimiser state; loaded
            # into a model of its own on the CPU, the live state left as it is.
            from ml_audio_inpainting_torch.models.build import build_generator, build_model

            tree = best_ckpt.load_tree(result.best_step)
            if args.model == "gan":
                tree, model = tree["g"], build_generator(cfg, "cpu")
            else:
                model = build_model(cfg, "cpu")
            model.load_state_dict(tree["model"])
            result.best_npz = run.checkpoint_dir / "best_inference.npz"
            export_params_npz(result.best_npz, model, params=tree["ema_params"])
            run.logger.info("probe-best inference weights exported: %s", result.best_npz)
        best_ckpt.close()
    run.logger.info("training done at step %d", step)
    run.close()
    return result


if __name__ == "__main__":
    main()

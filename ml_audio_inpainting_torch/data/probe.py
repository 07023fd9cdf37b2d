"""Real-clip probe sets (port of ``ml_audio_inpainting_tpu/data/probe.py``):
every audio file of a directory, one copy a gap position."""

from __future__ import annotations

from pathlib import Path
from typing import Sequence, Tuple, Union

import numpy as np

__all__ = ["load_real_probe_set"]


def load_real_probe_set(
    probe_dir: Union[str, Path],
    positions: Sequence[float],
    sample_rate: int,
    max_len_s: float,
    gap_len_s: float = 0.08,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Load every audio file under ``probe_dir`` and repeat it once a gap
    position (seconds).

    Returns ``(clips (F*P, S) float32, gap_starts (F*P,) int32, n_files)``,
    host numpy.  The starts are clamped so that a ``gap_len_s`` gap fits
    inside the clip.
    """
    from ml_audio_inpainting_torch.cli.inpaint import _collect
    from ml_audio_inpainting_torch.data.audio_io import load_audio

    probe_dir = Path(probe_dir)
    if not probe_dir.exists():
        raise FileNotFoundError(f"probe dir {probe_dir} does not exist")
    files = _collect(probe_dir)
    if not files:
        raise FileNotFoundError(f"no audio files under {probe_dir}")
    base = np.stack([load_audio(f, sample_rate=sample_rate, max_len=max_len_s)[0] for f in files])
    clips = np.repeat(base, len(positions), axis=0)
    starts = np.tile(np.asarray([int(t * sample_rate) for t in positions]), len(files))
    gl = int(gap_len_s * sample_rate)
    starts = np.clip(starts, 0, clips.shape[-1] - gl - 1).astype(np.int32)
    return clips, starts, len(files)

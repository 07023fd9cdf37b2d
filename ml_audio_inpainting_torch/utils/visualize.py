"""Spectrogram plots (port of ``ml_audio_inpainting_tpu/utils/visualize.py``,
the reference's ``visualize_spectrogram``, ``utils.py:395-478``): dB
conversion unless ``in_db``, gap-interval lines, a colour bar, the figure
saved or returned.  A plot needs matplotlib; where it is not installed the
function draws nothing and returns None (callers skip a None figure)."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

__all__ = ["visualize_spectrogram"]


def visualize_spectrogram(
    spectrogram,
    power: int = 1,
    sample_rate: int = 16000,
    n_fft: int = 512,
    hop_length: int = 192,
    win_length: int = 384,
    gap_int: Optional[Tuple[float, float]] = None,
    in_db: bool = False,
    y_axis: str = "log",
    x_axis: str = "time",
    title: str = "Spectrogram",
    save_path: Optional[Union[str, Path]] = None,
):
    """A figure of the ``(F, N)`` magnitude ``spectrogram`` (numpy, or a
    tensor on any device) on a symmetric-log frequency axis, or None when
    saved to ``save_path`` or when matplotlib is absent."""
    if power not in (1, 2):
        raise ValueError("Power must be 1 (energy) or 2 (power)")
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if hasattr(spectrogram, "detach"):
        spectrogram = spectrogram.detach().cpu().numpy()
    spec = np.asarray(spectrogram)
    if not in_db:
        amin = 1e-5
        p = np.maximum(spec, amin) ** (2 if power == 1 else 1)
        ref = np.max(p)
        db = 10.0 * (np.log10(p) - np.log10(max(ref, amin)))
        spec = np.maximum(db, db.max() - 80.0)

    n_freq, n_time = spec.shape
    freqs = np.linspace(0, sample_rate / 2, n_freq)
    times = np.arange(n_time) * hop_length / sample_rate

    fig, ax = plt.subplots(figsize=(10, 4))
    img = ax.pcolormesh(times, freqs, spec, shading="auto", cmap="magma")
    if y_axis == "log":
        ax.set_yscale("symlog", linthresh=64.0)
        ax.set_ylim(freqs[1], freqs[-1])
    ax.set_xlabel("Time" if x_axis == "time" else "Frames")
    ax.set_ylabel("Hz")

    if gap_int is not None:
        gs, ge = gap_int
        ax.axvline(x=gs, color="white", linestyle="--", label="Gap Start")
        ax.axvline(x=ge, color="white", linestyle="--", label="Gap End")
        ax.legend()

    fig.colorbar(img, ax=ax, format="%+2.0f dB")
    ax.set_title(title)
    fig.tight_layout()

    if save_path is not None:
        save_path = Path(save_path)
        save_path.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path)
        plt.close(fig)
        return None
    return fig

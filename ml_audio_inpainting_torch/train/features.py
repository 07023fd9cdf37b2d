"""Training features of the CNN+BiLSTM: waveforms and gap positions -> model
batches (port of ``ml_audio_inpainting_tpu/train/features.py::cnn_features``).

The JAX function draws the gap positions from a ``jax.random`` key inside
the step; this one takes them as an explicit ``(B, G)`` tensor (a
``torch.Generator`` cannot reproduce ``jax.random``'s stream, and the tests
feed both packages the same positions).  As there, the clean STFT is
computed once per clip and shared by its G gap variants.
"""

from __future__ import annotations

from typing import Dict

import torch

from ml_audio_inpainting_torch.ops import masking
from ml_audio_inpainting_torch.ops.gaps import gap_mask
from ml_audio_inpainting_torch.ops.stft import stft
from ml_audio_inpainting_torch.utils.config import SpectrogramConfig

__all__ = ["cnn_features"]


def cnn_features(
    audio: torch.Tensor,
    gap_start: torch.Tensor,
    spec: SpectrogramConfig,
    gap_len_s: float = 0.2,
    sample_rate: int = 16000,
    n_gaps: int = 1,
) -> Dict[str, torch.Tensor]:
    """CNN+BiLSTM batch features for ``audio (B, S)`` and ``gap_start (B, G)``
    integer sample positions: each clip becomes G variants, variant ``g`` of
    clip ``b`` with a gap of ``int(gap_len_s * sample_rate)`` samples at
    ``gap_start[b, g]`` (ending at the clip's end at the latest).  Returns,
    each ``(B*G, F, N)`` with variants of a clip adjacent:

    * ``log_gap``    ``log10(|STFT(gapped)| + 1e-9)``, the model input;
    * ``gap_mask``   1 = gap frame, 0 = valid; frames ``[s // hop, e // hop)``
      (floor at both ends, ``features.py:162-168``);
    * ``target_mag`` ``|STFT(clean)|``, repeated for each variant.

    ``n_gaps > 1`` (several gaps per variant) waits for a later slice of
    the port and raises ``NotImplementedError``.
    """
    if n_gaps != 1:
        raise NotImplementedError(
            "n_gaps > 1 (multi-gap training corruption, data/multigap.py) waits for a "
            "later slice of the port"
        )
    B, S = audio.shape
    G = gap_start.shape[1]
    kw = dict(n_fft=spec.n_fft, hop_length=spec.hop_length, win_length=spec.win_length)
    gap_len = int(gap_len_s * sample_rate)
    start = gap_start.to(device=audio.device, dtype=torch.int64)
    end = torch.clamp(start + max(gap_len, 0), max=S)
    masks = gap_mask(S, start, end - start, dtype=audio.dtype)  # (B, G, S), 1 = valid

    spec_clean = stft(audio, **kw)  # (B, F, N), once per clip
    F, N = spec_clean.shape[-2:]
    log_gap = masking.log10_norm(stft(audio[:, None] * masks, **kw).abs())  # (B, G, F, N)

    hop = spec.hop_length
    t = torch.arange(N, device=audio.device)
    hole = (t >= (start // hop)[..., None]) & (t < (end // hop)[..., None])  # (B, G, N)
    gmask = hole.to(audio.dtype)[..., None, :].expand(B, G, F, N)
    return {
        "log_gap": log_gap.reshape(B * G, F, N),
        "gap_mask": gmask.reshape(B * G, F, N),
        "target_mag": spec_clean.abs().repeat_interleave(G, dim=0),
    }

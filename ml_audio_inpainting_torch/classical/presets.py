"""Measured per-gap-length solver presets of the classical path (a copy of
``ml_audio_inpainting_tpu/classical/presets.py``, pure Python; its docstring
tells how each band was measured: ``results/ar_tuned_per_length.json``,
``results/ar_blend_sweep.json``, ``results/ar_context_sweep.json`` and
``results/janssen_tuned_gl0.*.json``).

The reference ships one configuration per solver (``arinpaint.m``: order
512, maxlen 4096, cos^2 crossfade; ``janssen_inp.m``: maxit 10).
``--ar-preset tuned`` deploys the measured winners instead:

* arinpaint on (0.075, 0.09] s: order 512, context 8192, ``sigmoid`` blend
  k=2 (the 80 ms champion, +2.84 dB vs the defaults' +2.55); everywhere
  else order 256, context 4096, ``linear`` blend with floor 0.2 (the 40 ms
  winner, which a pairwise probe prefers to the defaults at every measured
  length).
* gap-wise Janssen: context 8192, maxit 5 up to 0.18 s; context 16384,
  maxit 5 on (0.18, 0.41]; the defaults past 0.41 s (no grid was run).
"""

from __future__ import annotations

__all__ = ["tuned_arinpaint_preset", "tuned_janssen_preset"]


def tuned_arinpaint_preset(gap_len_s: float) -> dict:
    """Measured-best ``arinpaint`` overrides for a gap length (seconds): a
    dict of CLI-arg overrides (``ar_order``, ``ar_context``, ``ar_blend``,
    ``ar_blend_param``)."""
    if 0.075 < gap_len_s <= 0.09:
        return {
            "ar_order": 512,
            "ar_context": 8192,
            "ar_blend": "sigmoid",
            "ar_blend_param": 2.0,
        }
    return {
        "ar_order": 256,
        "ar_context": 4096,
        "ar_blend": "linear",
        "ar_blend_param": 0.2,
    }


def tuned_janssen_preset(gap_len_s: float) -> dict:
    """Measured-best gap-wise Janssen overrides for a gap length (seconds):
    ``ar_context`` and ``maxit``; empty past 0.41 s."""
    if gap_len_s <= 0.18:
        return {"ar_context": 8192, "maxit": 5}
    if gap_len_s <= 0.41:
        return {"ar_context": 16384, "maxit": 5}
    return {}

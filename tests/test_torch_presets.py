"""The port's copies of the pure-Python classical modules against the JAX
package's: ``classical/presets.py`` (equal dicts over a grid of gap
lengths through every band edge and a point just past each) and
``classical/support.py`` (equal outputs over a grid of windows, shifts and
gaps)."""

import pytest

from ml_audio_inpainting_tpu.classical import presets as jax_presets
from ml_audio_inpainting_tpu.classical import support as jax_support
from ml_audio_inpainting_torch.classical import presets, support
from torch_threads import one_thread  # noqa: F401  (a module fixture)

EDGES = (0.075, 0.09, 0.18, 0.30, 0.41)
GRID = sorted({0.0, 0.01, 0.04, 0.06, 0.08, 0.1, 0.16, 0.2, 0.24, 0.32, 0.5, 1.0,
               *EDGES, *(e + 1e-9 for e in EDGES), *(e - 1e-9 for e in EDGES)})


@pytest.mark.parametrize("gap_len_s", GRID)
def test_presets_match_jax(gap_len_s):
    assert presets.tuned_arinpaint_preset(gap_len_s) == jax_presets.tuned_arinpaint_preset(
        gap_len_s)
    assert presets.tuned_janssen_preset(gap_len_s) == jax_presets.tuned_janssen_preset(gap_len_s)


def test_preset_bands():
    assert presets.tuned_arinpaint_preset(0.08)["ar_context"] == 8192
    assert presets.tuned_arinpaint_preset(0.075)["ar_order"] == 256
    assert presets.tuned_arinpaint_preset(0.0900001)["ar_blend"] == "linear"
    assert presets.tuned_janssen_preset(0.18) == {"ar_context": 8192, "maxit": 5}
    assert presets.tuned_janssen_preset(0.2) == {"ar_context": 16384, "maxit": 5}
    assert presets.tuned_janssen_preset(0.41) == {"ar_context": 16384, "maxit": 5}
    assert presets.tuned_janssen_preset(0.42) == {}


@pytest.mark.parametrize("kind", ["full", "half", "none"])
@pytest.mark.parametrize("s,f,a", [(0, 0, 256), (32000, 33279, 1024), (1000, 1500, 512),
                                   (7, 900, 300), (40000, 47999, 2048)])
def test_gap_offset_matches_jax(kind, s, f, a):
    assert support.gap_offset(s, f, a, kind) == jax_support.gap_offset(s, f, a, kind)


@pytest.mark.parametrize("w,a", [(4096, 1024), (2048, 512), (1001, 250)])
@pytest.mark.parametrize("s,f", [(32000, 33279), (5000, 5100), (20000, 27999)])
def test_min_sig_supp_matches_jax(w, a, s, f):
    for kind in ("full", "half"):
        off = support.gap_offset(s, f, a, kind)
        assert vars(support.min_sig_supp(w, a, s, f, 80000, off)) == vars(
            jax_support.min_sig_supp(w, a, s, f, 80000, off))


def test_gap_offset_rejects_unknown_kinds():
    with pytest.raises(ValueError, match="kind"):
        support.gap_offset(0, 10, 64, "quarter")

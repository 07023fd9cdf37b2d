"""The port's corpus CLIs against the JAX package's on the CPU:
``cli/preprocess.py`` and ``cli/build_gaps_table.py``, both in-process on
the same FLAC tree (the port's with ``--device cpu``).

What is held, and how close:

* ``preprocess`` with a fixed ``--gap-start``: the mirrored tree, and every
  file decodes equal to JAX's, bit for bit (both write ``audio * mask``
  unnormalised: a product by 0 or 1 is exact).  With random starts (the
  port draws from a ``torch.Generator``, JAX from a key, so the two place
  the gaps apart): each output is its decoded input with one run of
  ``int(gap_len * sr)`` zeros inside the clip, and the same ``--seed`` gives
  the same tree twice;
* ``build_gaps_table --mode fixed``: the JSON equal to JAX's, and the
  ``--write-audio`` files decode equal;
* ``--mode multi``: the port's own layout (its generator again) holds
  ``--n-gaps``, ``[--min-gap-ms, --max-gap-ms]`` and ``--min-dist`` from
  each other and from both edges; its table has JAX's keys; JAX's
  ``apply_gaps_with_fades`` on the port's gaps, written by JAX's codec,
  decodes within one 16-bit LSB of the port's file (the two cos^2 fades
  round apart by an ulp).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from ml_audio_inpainting_tpu.cli import build_gaps_table as jax_build_gaps_table
from ml_audio_inpainting_tpu.cli import preprocess as jax_preprocess
from ml_audio_inpainting_tpu.data import audio_io as jio
from ml_audio_inpainting_tpu.data.multigap import apply_gaps_with_fades as jax_fades
from ml_audio_inpainting_torch.cli import build_gaps_table, preprocess
from ml_audio_inpainting_torch.runtime.synthetic import speech_like_batch
from torch_threads import one_thread  # noqa: F401  (a module fixture)

SR = 16000
LSB = 1.0 / 32768
GAP_LEN_S = 0.1
N_GAPS, MIN_GAP_MS, MAX_GAP_MS, MIN_DIST = 3, 10.0, 40.0, 1000


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A nested tree of five seeded speech-like clips of 0.6-1.2 s (shorter
    ones are padded to ``--max-len 1.0``, longer ones cut)."""
    root = tmp_path_factory.mktemp("corpus") / "train"
    rng = np.random.default_rng(5)
    for i, sub in enumerate(["a", "a", "b/c", "b/c", "."]):
        clip = speech_like_batch(rng, 1, 0.6 + 0.15 * i)[0] * 0.8
        jio.save_audio(clip, root / sub / f"clip{i}.flac", SR, normalize=False)
    return root


def _decoded(root):
    root = Path(root)
    return {p.relative_to(root).as_posix(): jio.read_audio(p)[0][:, 0]
            for p in sorted(root.rglob("*.flac"))}


def _inputs(tree):
    """Each input as the CLIs read it: decoded, cut or padded to 1 s."""
    return {name: np.pad(x, (0, max(0, SR - len(x))))[:SR] for name, x in _decoded(tree).items()}


def test_preprocess_fixed_start_matches_jax(tree, tmp_path):
    common = ["--input", str(tree), "--gap-len", str(GAP_LEN_S), "--gap-start", "0.3",
              "--max-len", "1.0", "--batch-size", "2"]
    jax_preprocess.main([*common, "--output", str(tmp_path / "jax")])
    written = preprocess.main([*common, "--output", str(tmp_path / "port"), "--device", "cpu"])
    got, want = _decoded(tmp_path / "port"), _decoded(tmp_path / "jax")
    assert sorted(got) == sorted(want) == sorted(_decoded(tree)) and len(written) == 5
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert np.all(got[name][4800:4800 + 1600] == 0.0)


def _one_gap_start(out, inp, gap_len):
    """A start ``s`` such that ``out`` is ``inp`` with ``[s, s + gap_len)``
    zeroed (inside one run of zeros of ``out``), or None."""
    changed = np.flatnonzero(out != inp)
    edges = np.flatnonzero(np.diff(np.concatenate([[0], out == 0, [0]]).astype(np.int8)))
    for a, b in zip(edges[::2], edges[1::2]):  # the runs of zeros, [a, b)
        lo, hi = a, b - gap_len
        if len(changed):
            lo, hi = max(lo, changed[-1] - gap_len + 1), min(hi, changed[0])
        if lo <= hi:
            return int(lo)
    return None


def test_preprocess_random_starts_one_gap_a_file_and_seeded(tree, tmp_path):
    common = ["--input", str(tree), "--gap-len", str(GAP_LEN_S), "--max-len", "1.0",
              "--batch-size", "3", "--seed", "4", "--device", "cpu"]
    preprocess.main([*common, "--output", str(tmp_path / "one")])
    preprocess.main([*common, "--output", str(tmp_path / "two")])
    one, two, inputs = _decoded(tmp_path / "one"), _decoded(tmp_path / "two"), _inputs(tree)
    assert sorted(one) == sorted(two) == sorted(inputs)
    gap_len = int(GAP_LEN_S * SR)
    starts = set()
    for name, x in one.items():
        np.testing.assert_array_equal(x, two[name], err_msg=name)
        s = _one_gap_start(x, inputs[name], gap_len)
        assert s is not None and 0 <= s <= SR - gap_len, name
        starts.add(s)
    assert len(starts) > 1  # drawn a file each, not one start for all


def test_build_gaps_table_fixed_matches_jax(tree, tmp_path):
    common = ["--input", str(tree), "--gap-lens-ms", "80", "40", "--gap-start", "0.5",
              "--max-len", "1.0"]
    jax_build_gaps_table.main([*common, "--output", str(tmp_path / "jax.json"),
                               "--write-audio", str(tmp_path / "jax")])
    table = build_gaps_table.main([*common, "--output", str(tmp_path / "port.json"),
                                   "--write-audio", str(tmp_path / "port"), "--device", "cpu"])
    got = json.loads((tmp_path / "port.json").read_text())
    assert got == json.loads((tmp_path / "jax.json").read_text()) == table
    assert got["entries"][0]["gaps"] == [[8000, 1280]]
    got_audio, want_audio = _decoded(tmp_path / "port"), _decoded(tmp_path / "jax")
    assert sorted(got_audio) == sorted(want_audio) and len(got_audio) == 5
    for name in want_audio:
        np.testing.assert_array_equal(got_audio[name], want_audio[name], err_msg=name)


def test_build_gaps_table_multi_layout_and_fades(tree, tmp_path):
    common = ["--input", str(tree), "--mode", "multi", "--n-gaps", str(N_GAPS),
              "--min-gap-ms", str(MIN_GAP_MS), "--max-gap-ms", str(MAX_GAP_MS),
              "--min-dist", str(MIN_DIST), "--max-len", "1.0", "--seed", "3"]
    jax_build_gaps_table.main([*common, "--output", str(tmp_path / "jax.json")])
    build_gaps_table.main([*common, "--output", str(tmp_path / "port.json"), "--write-audio",
                           str(tmp_path / "port"), "--device", "cpu"])
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    strip = lambda t: {**t, "entries": [{k: v for k, v in e.items() if k != "gaps"}
                                        for e in t["entries"]]}  # noqa: E731
    assert strip(got) == strip(want)

    lo, hi = int(MIN_GAP_MS * SR / 1000), int(MAX_GAP_MS * SR / 1000)
    inputs = {Path(n).name: x for n, x in _inputs(tree).items()}
    written = _decoded(tmp_path / "port")
    layouts = set()
    for entry in got["entries"]:
        gaps = entry["gaps"]
        assert len(gaps) == N_GAPS
        assert all(lo <= l <= hi for _, l in gaps), gaps
        edges = [0] + [e for s, l in gaps for e in (s, s + l)] + [SR]
        assert all(b - a >= MIN_DIST for a, b in zip(edges[::2], edges[1::2])), gaps
        layouts.add(json.dumps(gaps))
        starts, lengths = (jnp.asarray([g[i] for g in gaps]) for i in (0, 1))
        jio.save_audio(np.asarray(jax_fades(jnp.asarray(inputs[entry["file"]]), starts, lengths,
                                            fade_len=32)),
                       tmp_path / "jax" / entry["file"], SR, normalize=False)
        mine = written[Path(entry["file"]).stem + "_gapped.flac"]
        theirs = jio.read_audio(tmp_path / "jax" / entry["file"])[0][:, 0]
        assert np.abs(mine - theirs).max() <= LSB * 1.0001, entry["file"]
        for s, l in gaps:
            assert np.all(mine[s:s + l] == 0)
    assert len(layouts) == len(got["entries"])  # a layout a file

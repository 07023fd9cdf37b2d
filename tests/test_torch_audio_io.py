"""The port's audio codec and its binding (``native/audioio.cpp``,
``data/audio_io.py``) against the JAX package's on the CPU.

The codec is a copy of the JAX package's source, so everything is held bit
for bit: the three committed FLACs decode to the same samples (their
STREAMINFO MD5 verified); the same input encodes to the same bytes, FLAC
and WAV (16-bit; 24-bit WAV raises in both), mono and stereo;
``load_audio``'s mixdown, padding, truncation and
resampling give the same arrays.  Corrupt files (truncated, one bit
flipped, garbage, empty, missing) raise ``AudioIOError``.  The library is
built at first use under a name keyed by its source and flags; two
processes that build it at once both load a whole library, and a failed
build raises with the compiler's output.
"""

import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from ml_audio_inpainting_tpu.data import audio_io as jio
from ml_audio_inpainting_torch.data import audio_io as tio
from torch_threads import one_thread  # noqa: F401  (a module fixture)

REPO = Path(__file__).resolve().parent.parent
FLACS = sorted((REPO / "results" / "formant_corpus_samples").glob("*.flac"))
_PYGAME = importlib.util.find_spec("pygame")
# The JAX package's MP3 sample (tests/test_mp3.py): pygame's example data.
MP3_SAMPLE = (Path(_PYGAME.origin).parent / "examples" / "data" / "house_lo.mp3"
              if _PYGAME and _PYGAME.origin else Path("house_lo.mp3.absent"))


def _noise(frames, channels, seed=0, scale=0.3):
    x = np.random.default_rng(seed).standard_normal((frames, channels)) * scale
    return np.clip(x, -1.0, 1.0).astype(np.float32)


def test_committed_flacs_exist():
    assert len(FLACS) == 3


@pytest.mark.parametrize("path", FLACS, ids=lambda p: p.name)
def test_committed_flac_decodes_bit_for_bit(path):
    got, rate, md5_ok = tio.read_audio(path)
    want, want_rate, want_md5 = jio.read_audio(path)
    assert (rate, md5_ok) == (want_rate, want_md5) == (16000, 1)
    assert got.dtype == np.float32 and got.shape == want.shape == (80000, 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["flac", "wav"])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bits", [16, 24])
def test_write_matches_jax_bytes_and_round_trips(tmp_path, fmt, channels, bits):
    x = _noise(7001, channels, seed=channels)
    mine, theirs = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
    if fmt == "wav" and bits != 16:  # the codec writes 16-bit WAV only, in both packages
        with pytest.raises(tio.AudioIOError, match="16-bit"):
            tio.write_audio(mine, x, 16000, bits=bits)
        with pytest.raises(IOError, match="16-bit"):
            jio.write_audio(theirs, x, 16000, bits=bits)
        return
    tio.write_audio(mine, x if channels > 1 else x[:, 0], 16000, bits=bits)
    jio.write_audio(theirs, x if channels > 1 else x[:, 0], 16000, bits=bits)
    assert mine.read_bytes() == theirs.read_bytes()
    got, rate, md5_ok = tio.read_audio(mine)
    assert rate == 16000 and got.shape == (7001, channels)
    assert md5_ok == (1 if fmt == "flac" else -1)
    scale = 2.0 ** (bits - 1)  # PCM quantisation: round(x * scale) / scale
    np.testing.assert_allclose(got, x, rtol=0, atol=1.0 / scale)
    np.testing.assert_array_equal(got, jio.read_audio(theirs)[0])


def test_file_format_argument_overrides_the_suffix(tmp_path):
    x = _noise(3000, 1)[:, 0]
    tio.write_audio(tmp_path / "a.flac", x, 8000, file_format="wav")
    assert (tmp_path / "a.flac").read_bytes()[:4] == b"RIFF"
    tio.write_audio(tmp_path / "b.dat", x, 8000, file_format="flac")
    assert (tmp_path / "b.dat").read_bytes()[:4] == b"fLaC"


@pytest.mark.parametrize("case", ["pad", "truncate", "mixdown", "first_channel", "resample"])
def test_load_audio_matches_jax(tmp_path, case):
    frames, channels, rate = {"pad": (20000, 1, 16000), "truncate": (100000, 1, 16000),
                              "mixdown": (30000, 2, 16000), "first_channel": (30000, 2, 16000),
                              "resample": (44100, 1, 44100)}[case]
    path = tmp_path / "in.flac"
    jio.write_audio(path, _noise(frames, channels, seed=3), rate)
    kw = dict(sample_rate=16000, max_len=2.0, mono=case != "first_channel")
    got, sr = tio.load_audio(path, **kw)
    want, want_sr = jio.load_audio(path, **kw)
    assert sr == want_sr == 16000 and got.dtype == np.float32 and got.shape == (32000,)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_save_audio_normalises_and_takes_tensors(tmp_path):
    x = 0.25 * _noise(4000, 1, seed=4)[:, 0]
    tio.save_audio(torch.tensor(x), tmp_path / "sub" / "norm.flac")  # makes the directory
    jio.save_audio(x, tmp_path / "jax.flac")
    assert (tmp_path / "sub" / "norm.flac").read_bytes() == (tmp_path / "jax.flac").read_bytes()
    got = tio.read_audio(tmp_path / "sub" / "norm.flac")[0][:, 0]
    assert abs(np.abs(got).max() - 1.0) <= 1.0 / 32768
    tio.save_audio(x, tmp_path / "raw.wav", normalize=False, file_format="wav")
    np.testing.assert_allclose(tio.read_audio(tmp_path / "raw.wav")[0][:, 0], x, atol=1 / 32768)
    tio.save_audio(np.zeros(100, np.float32), tmp_path / "silent.flac")  # peak 0: unscaled
    assert not tio.read_audio(tmp_path / "silent.flac")[0].any()


def _corrupt(tmp_path, how):
    data = bytearray(FLACS[0].read_bytes())
    if how == "truncated":
        data = data[: len(data) // 2]
    elif how == "bit_flipped":
        data[len(data) // 2] ^= 0x10
    elif how == "garbage":
        data = bytearray(np.random.default_rng(5).bytes(4096))
    elif how == "empty":
        data = bytearray()
    path = tmp_path / f"{how}.flac"
    path.write_bytes(bytes(data))
    return path


@pytest.mark.parametrize("how", ["truncated", "bit_flipped", "garbage", "empty"])
def test_corrupt_files_raise(tmp_path, how):
    path = _corrupt(tmp_path, how)
    with pytest.raises(tio.AudioIOError):
        tio.read_audio(path)
    with pytest.raises(tio.AudioIOError):
        tio.load_audio(path)
    with pytest.raises(IOError):  # the JAX package's reader agrees
        jio.read_audio(path)


def test_missing_file_and_unwritable_path_raise(tmp_path):
    with pytest.raises(tio.AudioIOError, match="cannot open"):
        tio.load_audio(tmp_path / "missing.flac")
    (tmp_path / "file").write_bytes(b"x")
    with pytest.raises(tio.AudioIOError):
        tio.save_audio(np.ones(10, np.float32), tmp_path / "file" / "out.flac")


@pytest.mark.skipif(not MP3_SAMPLE.exists(), reason="no MP3 sample on this host")
def test_mp3_decodes_as_jax_does():
    got, rate, md5_ok = tio.read_audio(MP3_SAMPLE)
    want, want_rate, _ = jio.read_audio(MP3_SAMPLE)
    assert (rate, md5_ok) == (want_rate, -1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tio.load_audio(MP3_SAMPLE)[0],
                                  np.asarray(jio.load_audio(MP3_SAMPLE)[0]))


_BUILD = textwrap.dedent(
    """
    import sys, time
    from pathlib import Path
    from ml_audio_inpainting_torch.data import audio_io
    audio_io.BUILD_DIR = Path(sys.argv[1])
    go = Path(sys.argv[2])
    while not go.exists():
        time.sleep(0.01)
    lib = audio_io.load_library()
    x, rate, md5_ok = audio_io.read_audio(sys.argv[3])
    print(lib.path.name, lib.build_seconds > 0, x.shape[0], md5_ok)
    """
)


def test_two_processes_building_at_once_both_load(tmp_path):
    build, go = tmp_path / "build", tmp_path / "go"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build), str(go), str(FLACS[0])],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    go.touch()
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = [o[0].split() for o in outs]
    assert lines[0][0] == lines[1][0]  # one name: the source's and flags' hash
    assert all(line[2:] == ["80000", "1"] for line in lines)
    assert [p.name for p in build.iterdir()] == [lines[0][0]]  # no temporary file left


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    bad = tmp_path / "audioio.cpp"
    bad.write_text("int main( {\n")
    code = textwrap.dedent(
        f"""
        from pathlib import Path
        from ml_audio_inpainting_torch.data import audio_io
        audio_io.BUILD_DIR = Path({str(tmp_path / "build")!r})
        audio_io.SOURCE = Path({str(bad)!r})
        try:
            audio_io.read_audio("x.flac")
        except RuntimeError as e:
            print("RAISED", "audioio.cpp" in str(e) and "error" in str(e))
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.split() == ["RAISED", "True"], out.stdout + out.stderr
    assert not any((tmp_path / "build").iterdir())

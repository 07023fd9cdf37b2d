"""Host-side audio file I/O: the port's native FLAC/WAV codec bound with
``ctypes`` (port of ``ml_audio_inpainting_tpu/data/audio_io.py``).

``native/audioio.cpp`` is the port's own copy of the JAX package's codec: a
FLAC decoder checked against the MD5 signature in every FLAC STREAMINFO
header, a fixed-predictor FLAC encoder, WAV (PCM 8/16/24/32, float32), and
MP3 through the system's libmpg123 where it is installed.  It is built at
first use, never at import, by one ``g++`` call into the git-ignored
``ml_audio_inpainting_torch/_build/``, under a name keyed by a hash of the
source and the flags, and loaded with ``ctypes``.  Each build writes a
file of its own and renames it into place, so processes that build at once
(pytest workers) never load half a library.  A failed build raises with the
compiler's output; there is no other decoder to fall back on.

* :func:`load_audio` -- decode, mix down to mono, resample, truncate or
  zero-pad to ``max_len`` seconds.
* :func:`save_audio` -- peak-normalise, make the directory, write FLAC or
  WAV.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
import uuid
from dataclasses import dataclass
from math import gcd
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

__all__ = [
    "AudioIOError",
    "CXX_FLAGS",
    "SOURCE",
    "load_library",
    "read_audio",
    "write_audio",
    "resample",
    "load_audio",
    "save_audio",
]

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE / "native" / "audioio.cpp"
BUILD_DIR = _PACKAGE / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LINK = ("-ldl",)  # dlopen of the system MP3 codec on hosts before glibc 2.34

_lock = threading.Lock()
_library: Optional["CodecLibrary"] = None


class AudioIOError(IOError):
    """A file could not be decoded or encoded."""


@dataclass(frozen=True)
class CodecLibrary:
    """The loaded codec and what building it took."""

    cdll: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when a library of the same source and flags was found


def load_library() -> CodecLibrary:
    """Build the codec (unless a library of the same source, compiler and
    flags is already built) and load it, once a process.  Raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    global _library
    with _lock:
        if _library is not None:
            return _library
        cxx = os.environ.get("CXX", "g++")
        key = SOURCE.read_bytes() + " ".join((cxx, *CXX_FLAGS, *_LINK)).encode()
        path = BUILD_DIR / f"libaudioio_{hashlib.sha256(key).hexdigest()[:16]}.so"
        seconds = 0.0
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.{uuid.uuid4().hex}.tmp")
            cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *_LINK]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building the audio codec failed (exit {proc.returncode}): "
                                   f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
        lib = ctypes.CDLL(str(path))
        lib.mai_read_audio.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.mai_read_audio.restype = ctypes.c_int
        lib.mai_write_audio.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.mai_write_audio.restype = ctypes.c_int
        lib.mai_free.argtypes = [ctypes.c_void_p]
        lib.mai_free.restype = None
        _library = CodecLibrary(lib, path, seconds)
        return _library


def read_audio(path: Union[str, Path]) -> Tuple[np.ndarray, int, int]:
    """Decode a FLAC, WAV or MP3 file: ``(samples (frames, channels) f32,
    rate, md5_ok)``; ``md5_ok`` is 1 if the FLAC stream's MD5 matched the
    decode, 0 if it did not, -1 where there is none (WAV, MP3, a FLAC
    without one)."""
    lib = load_library().cdll
    data = ctypes.POINTER(ctypes.c_float)()
    frames, channels = ctypes.c_int64(), ctypes.c_int32()
    rate, md5_ok = ctypes.c_int32(), ctypes.c_int32()
    err = ctypes.create_string_buffer(256)
    rc = lib.mai_read_audio(str(path).encode(), ctypes.byref(data), ctypes.byref(frames),
                            ctypes.byref(channels), ctypes.byref(rate), ctypes.byref(md5_ok),
                            err, len(err))
    if rc != 0:
        raise AudioIOError(f"Error loading audio file {path}: {err.value.decode()}")
    n = frames.value * channels.value
    try:
        out = np.ctypeslib.as_array(data, shape=(n,)).reshape(frames.value, channels.value).copy()
    finally:
        lib.mai_free(data)
    return out, rate.value, md5_ok.value


def write_audio(path: Union[str, Path], samples: np.ndarray, sample_rate: int, bits: int = 16,
                file_format: Optional[str] = None) -> None:
    """Encode f32 samples ``(frames,)`` or ``(frames, channels)`` as FLAC
    (the default) or WAV (``file_format="wav"``, or a ``.wav`` path)."""
    lib = load_library().cdll
    samples = np.asarray(samples, dtype=np.float32)
    if samples.ndim == 1:
        samples = samples[:, None]
    if file_format is None:
        file_format = Path(path).suffix.lstrip(".").lower() or "flac"
    flat = np.ascontiguousarray(samples.reshape(-1))
    err = ctypes.create_string_buffer(256)
    rc = lib.mai_write_audio(str(path).encode(),
                             flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             samples.shape[0], samples.shape[1], sample_rate, bits,
                             1 if file_format == "wav" else 0, err, len(err))
    if rc != 0:
        raise AudioIOError(f"Error saving audio to {path}: {err.value.decode()}")


def resample(audio: np.ndarray, orig_rate: int, target_rate: int) -> np.ndarray:
    """Polyphase resampling on the host (``scipy.signal.resample_poly``)."""
    if orig_rate == target_rate:
        return audio
    from scipy.signal import resample_poly

    g = gcd(orig_rate, target_rate)
    return resample_poly(audio, target_rate // g, orig_rate // g).astype(audio.dtype)


def load_audio(file_path: Union[str, Path], sample_rate: int = 16000, max_len: float = 5.0,
               mono: bool = True) -> Tuple[np.ndarray, int]:
    """``(audio, sample_rate)``: the file mixed down to mono (its first
    channel when ``mono`` is False), resampled to ``sample_rate``, and cut or
    zero-padded to exactly ``int(sample_rate * max_len)`` f32 samples.  Every
    failure raises :class:`AudioIOError`."""
    try:
        samples, rate, _ = read_audio(file_path)
    except AudioIOError:
        raise
    except Exception as e:
        raise AudioIOError(f"Error loading audio file {file_path}: {e}") from e

    audio = samples.mean(axis=1) if (mono and samples.shape[1] > 1) else samples[:, 0]
    audio = resample(audio, rate, sample_rate)
    max_samples = int(sample_rate * max_len)
    if len(audio) > max_samples:
        audio = audio[:max_samples]
    else:
        audio = np.pad(audio, (0, max_samples - len(audio)))
    return np.ascontiguousarray(audio, dtype=np.float32), sample_rate


def save_audio(audio_data: np.ndarray, file_path: Union[str, Path], sample_rate: int = 16000,
               normalize: bool = True, file_format: str = "flac") -> None:
    """Write ``audio_data`` (a numpy array, or a tensor on any device) to
    ``file_path``, scaled to a peak of 1 when ``normalize``, making its
    directory if need be."""
    out_dir = Path(file_path).parent
    if not out_dir.exists():
        try:
            out_dir.mkdir(parents=True, exist_ok=True)
        except Exception as e:
            raise AudioIOError(f"Error creating directory {out_dir}: {e}") from e
    if hasattr(audio_data, "detach"):
        audio_data = audio_data.detach().cpu().numpy()
    audio_data = np.asarray(audio_data, dtype=np.float32)
    if normalize:
        peak = np.max(np.abs(audio_data))
        if peak > 0:
            audio_data = audio_data / peak
    write_audio(file_path, audio_data, sample_rate, file_format=file_format)

"""Training corpora (port of ``ml_audio_inpainting_tpu/data/dataset.py``):
directory trees of audio files, the deterministic synthetic speech of
``bench.py``'s canonical line, and the formant-synthesised pseudo-speech
behind every committed ``*_formant_*`` checkpoint.

Host numpy code, copied with its constants (the Peterson-Barney table
included), so an item is the JAX package's bit for bit for the same
``(seed, idx, variant)`` (one blake2s-seeded generator an item; the file
corpus decodes through the port's codec, ``data/audio_io.py``).  The host
side only produces fixed ``(max_samples,)`` f32 waveforms; gaps, STFTs and
normalisation run on the device inside the train step.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from ml_audio_inpainting_torch.data.audio_io import load_audio

__all__ = [
    "AudioFileDataset",
    "SyntheticSpeechDataset",
    "FormantSpeechDataset",
    "list_audio_files",
]

AUDIO_EXTENSIONS = (".flac", ".wav", ".mp3")


def list_audio_files(
    root: Union[str, Path], max_files: Optional[int] = None
) -> List[Path]:
    """Recursively collect audio files under ``root`` in sorted order
    (parity with the reference's sorted rglob, ``models/GAN/dataset.py:41-57``,
    ``models/CNNBLSTM/dataset.py:59-69``)."""
    root = Path(root)
    if not root.exists():
        raise ValueError(f"Path {root} does not exist")
    files = sorted(p for p in root.rglob("*") if p.suffix.lower() in AUDIO_EXTENSIONS)
    if max_files is not None:
        files = files[:max_files]
    return files


class AudioFileDataset:
    """Fixed-length waveform dataset over a directory tree of FLAC/WAV files.

    Every item is exactly ``int(sample_rate * max_len_s)`` samples
    (truncate-or-pad, the reference's audio contract, ``utils.py:39-48``).
    Decoded clips are cached in RAM (a 5 s clip is 320 KB; 3 000 clips < 1 GB),
    removing repeated decode work across epochs.
    """

    def __init__(
        self,
        root: Union[str, Path],
        sample_rate: int = 16000,
        max_len_s: float = 5.0,
        max_files: Optional[int] = None,
        cache: bool = True,
    ):
        self.files = list_audio_files(root, max_files)
        self.sample_rate = sample_rate
        self.max_len_s = max_len_s
        self.max_samples = int(sample_rate * max_len_s)
        self._cache: Optional[dict] = {} if cache else None

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        audio, _ = load_audio(
            self.files[idx], sample_rate=self.sample_rate, max_len=self.max_len_s
        )
        if self._cache is not None:
            self._cache[idx] = audio
        return audio


class SyntheticSpeechDataset:
    """Item ``idx`` is an AM-modulated stack of 6 harmonics over a noise
    floor, peak 1, ``int(sample_rate * max_len_s)`` f32 samples, drawn from
    a generator seeded by ``blake2s(f"{seed}:{idx}")``."""

    def __init__(
        self,
        n_items: int = 128,
        sample_rate: int = 16000,
        max_len_s: float = 5.0,
        seed: int = 0,
    ):
        self.n_items = n_items
        self.sample_rate = sample_rate
        self.max_samples = int(sample_rate * max_len_s)
        self.seed = seed

    def __len__(self) -> int:
        return self.n_items

    def __getitem__(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(
            int.from_bytes(
                hashlib.blake2s(f"{self.seed}:{idx}".encode(), digest_size=8).digest(),
                "little",
            )
        )
        t = np.arange(self.max_samples) / self.sample_rate
        f0 = rng.uniform(90, 250) + rng.uniform(10, 50) * np.sin(
            2 * np.pi * rng.uniform(0.3, 1.5) * t
        )
        phase = 2 * np.pi * np.cumsum(f0) / self.sample_rate
        sig = sum(
            (rng.uniform(0.2, 0.6) / k) * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
            for k in range(1, 7)
        )
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(1.0, 4.0) * t + rng.uniform(0, 2 * np.pi)))
        sig = env * sig + 0.01 * rng.standard_normal(self.max_samples)
        return (sig / np.max(np.abs(sig))).astype(np.float32)


#: Peterson & Barney (1952) average formant frequencies (F1, F2, F3) in Hz
#: for the 10 American-English monophthongs /i ɪ ɛ æ ɑ ɔ ʊ u ɝ ʌ/ -- the
#: classic measured vowel space, used by corpus v3 instead of v1/v2's
#: uniform-random formant draws.
_PB_MALE = np.array([
    [270.0, 2290.0, 3010.0],
    [390.0, 1990.0, 2550.0],
    [530.0, 1840.0, 2480.0],
    [660.0, 1720.0, 2410.0],
    [730.0, 1090.0, 2440.0],
    [570.0, 840.0, 2410.0],
    [440.0, 1020.0, 2240.0],
    [300.0, 870.0, 2240.0],
    [490.0, 1350.0, 1690.0],
    [640.0, 1190.0, 2390.0],
])
_PB_FEMALE = np.array([
    [310.0, 2790.0, 3310.0],
    [430.0, 2480.0, 3070.0],
    [610.0, 2330.0, 2990.0],
    [860.0, 2050.0, 2850.0],
    [850.0, 1220.0, 2810.0],
    [590.0, 920.0, 2710.0],
    [470.0, 1160.0, 2680.0],
    [370.0, 950.0, 2670.0],
    [500.0, 1640.0, 1960.0],
    [760.0, 1400.0, 2780.0],
])


class FormantSpeechDataset:
    """Formant-synthesized multi-speaker pseudo-speech (source-filter model).

    A much closer stand-in for read speech than
    :class:`SyntheticSpeechDataset`'s flat harmonic stack: each item is a
    Klatt-style cascade synthesis -- a sawtooth glottal source with phrase
    declination and jitter, driven through four time-varying formant
    resonators whose targets change per syllable, interleaved with
    fricative noise, plosive bursts, and silences in a syllabic rhythm.
    The structure the inpainting models must learn (formant trajectories,
    voiced/unvoiced alternation, pauses) is therefore actually present.

    Exists because no LibriSpeech corpus ships with the repository (the
    reference trains on a local train-clean-100 tree,
    ``models/CNNBLSTM/cnn_blstm.yaml:12``); this is the honest
    no-eval-overlap training corpus.  Items are deterministic in
    ``(seed, idx, variant)`` and RAM-cached (decode cost ~50 ms/item).

    ``variant="v1"`` (default) is byte-identical to the corpus behind the
    committed ``gan_formant_r2`` and ``cnn_blstm_formant_r2`` checkpoints.
    ``variant="v2"`` adds phenomena real read speech has and v1 lacks:
    per-speaker speaking rate and
    breathiness, diphthongs (within-vowel formant glides), nasal murmurs
    with an anti-resonance notch, onset consonant clusters
    (plosive+fricative), voiced fricatives, and accented-syllable f0
    excursions on top of the phrase declination.

    ``variant="v3"`` keeps everything in v2 and adds what
    real RECORDINGS of read speech have and clean synthesis lacks:

    * vowel targets drawn from the Peterson-Barney (1952) measured
      American-English formant table (per-speaker male/female group
      chosen by f0) instead of uniform-random F1/F2 draws;
    * locus-based coarticulation: the first third of each vowel glides
      from the onset consonant's F1/F2 locus to the vowel target (v1/v2
      transitions came only from symmetric track smoothing);
    * room reverberation: convolution with a synthetic RIR (direct path,
      2-8 ms pre-delay, exponentially-decaying noise tail, RT60
      0.12-0.5 s, direct-to-reverb ratio 3-12 dB) on half the items;
    * additive noise events: short band-limited bursts (page turns,
      thumps) and/or a steady background noise floor at 25-40 dB SNR.
    """

    #: per-frame hop of the parameter tracks (10 ms at 16 kHz)
    FRAME = 160

    def __init__(
        self,
        n_items: int = 128,
        sample_rate: int = 16000,
        max_len_s: float = 5.0,
        seed: int = 0,
        cache: bool = True,
        cache_dir: Optional[str] = None,
        variant: str = "v1",
    ):
        if variant not in ("v1", "v2", "v3"):
            raise ValueError(f"unknown corpus variant {variant!r}")
        self.n_items = n_items
        self.sample_rate = sample_rate
        self.max_samples = int(sample_rate * max_len_s)
        self.seed = seed
        self.variant = variant
        self._cache: Optional[dict] = {} if cache else None
        # Items are deterministic in (seed, idx), so an on-disk cache is
        # shareable across runs/processes (synthesis is ~0.3 s/item on one
        # core).  Set MAI_FORMANT_CACHE=/path to enable by default.
        cache_dir = cache_dir or os.environ.get("MAI_FORMANT_CACHE")
        self._cache_dir: Optional[Path] = None
        if cache_dir:
            self._cache_dir = Path(cache_dir)
            self._cache_dir.mkdir(parents=True, exist_ok=True)

    def _disk_path(self, idx: int) -> Optional[Path]:
        if self._cache_dir is None:
            return None
        tag = "" if self.variant == "v1" else f"_{self.variant}"
        return self._cache_dir / (
            f"formant{tag}_s{self.seed}_r{self.sample_rate}_n{self.max_samples}_{idx}.npy"
        )

    def __len__(self) -> int:
        return self.n_items

    # -- timeline ----------------------------------------------------------

    def _build_tracks(self, rng):
        """Frame-rate parameter tracks: voicing, gain, f0, formants, noise.

        All v2-only randomness is drawn inside ``if rich:`` guards placed
        *after* the v1 draws they follow, so the v1 stream (and therefore
        every committed v1 item) stays bit-identical.
        """
        sr = self.sample_rate
        rich = self.variant in ("v2", "v3")
        v3 = self.variant == "v3"
        n_frames = self.max_samples // self.FRAME + 1

        # Speaker identity.
        f0_base = np.exp(rng.uniform(np.log(85.0), np.log(235.0)))
        f_shift = rng.uniform(0.88, 1.18)  # vocal-tract length factor
        rate = rng.uniform(0.72, 1.35) if rich else 1.0  # speaking rate
        # v3: speaker's measured vowel table (Peterson-Barney group by f0).
        pb = _PB_FEMALE if f0_base > 155.0 else _PB_MALE

        voiced = np.zeros(n_frames)
        gain = np.zeros(n_frames)
        fric = np.zeros(n_frames)  # fricative/burst noise gain
        fric_freq = np.full(n_frames, 4500.0)
        nasal = np.zeros(n_frames)  # anti-resonance notch active
        f0 = np.full(n_frames, f0_base)
        # Formant targets, filled per syllable then smoothed.
        F = np.tile(np.array([500.0, 1500.0, 2500.0, 3600.0]), (n_frames, 1))

        frame_s = self.FRAME / sr
        accents = []  # (start, end) nucleus spans to accent in v2
        t_f = 0  # current frame
        while t_f < n_frames:
            # Pause between phrases.
            t_f += int(rng.uniform(0.08, 0.45) / frame_s)
            if t_f >= n_frames:
                break
            # One phrase: 3-14 syllables with f0 declination.
            n_syll = rng.integers(3, 15)
            phrase_start = t_f
            phrase_len_est = 0
            for _ in range(n_syll):
                if t_f >= n_frames:
                    break
                # Optional onset consonant.  v3 tracks the consonant's
                # formant LOCUS so the following vowel can glide from it
                # (coarticulation; v1/v2 transitions come only from the
                # symmetric track smoothing below).
                locus = None
                c = rng.uniform()
                if c < 0.22:  # plosive: silence then a short burst
                    t_f += int(rng.uniform(0.03, 0.07) / rate / frame_s)
                    burst = max(1, int(rng.uniform(0.01, 0.03) / frame_s))
                    e = min(n_frames, t_f + burst)
                    fric[t_f:e] = rng.uniform(0.5, 1.0)
                    fric_freq[t_f:e] = rng.uniform(1500.0, 6000.0)
                    t_f = e
                    if v3:
                        # Place of articulation -> classic F2 locus
                        # (labial ~700, alveolar ~1800, velar ~2300 Hz).
                        locus = (250.0, float(rng.choice([700.0, 1800.0, 2300.0])))
                    if rich and rng.uniform() < 0.35:
                        # Cluster: the plosive releases into a fricative
                        # (affricate / sC-cluster texture).
                        dur = max(1, int(rng.uniform(0.04, 0.10) / rate / frame_s))
                        e = min(n_frames, t_f + dur)
                        fric[t_f:e] = rng.uniform(0.2, 0.5)
                        fric_freq[t_f:e] = rng.uniform(2800.0, 6500.0)
                        t_f = e
                elif c < 0.50:  # fricative
                    dur = max(1, int(rng.uniform(0.05, 0.14) / rate / frame_s))
                    e = min(n_frames, t_f + dur)
                    ramp = np.minimum(np.arange(e - t_f) + 1, 4) / 4.0
                    fric[t_f:e] = rng.uniform(0.15, 0.5) * ramp
                    fq = rng.uniform(2800.0, 6500.0)
                    fric_freq[t_f:e] = fq
                    if v3:
                        locus = (250.0, float(np.clip(0.4 * fq, 900.0, 2300.0)))
                    if rich and rng.uniform() < 0.30:
                        # Voiced fricative (/z/, /v/): keep the glottal
                        # source running under the noise.
                        voiced[t_f:e] = 0.7
                        gain[t_f:e] = 0.4
                    t_f = e
                elif rich and c < 0.62:
                    # Nasal onset (/m/, /n/): voiced low murmur with an
                    # anti-resonance; F1 low, upper formants damped by the
                    # notch in synthesis.
                    dur = max(1, int(rng.uniform(0.04, 0.10) / rate / frame_s))
                    e = min(n_frames, t_f + dur)
                    F[t_f:e, 0] = rng.uniform(240.0, 320.0) * f_shift
                    F[t_f:e, 1] = rng.uniform(1000.0, 1400.0) * f_shift
                    voiced[t_f:e] = 1.0
                    gain[t_f:e] = rng.uniform(0.25, 0.45)
                    nasal[t_f:e] = 1.0
                    t_f = e
                    if v3:
                        locus = (280.0, 1200.0)
                # Voiced nucleus (vowel).
                dur = max(2, int(rng.uniform(0.07, 0.24) / rate / frame_s))
                e = min(n_frames, t_f + dur)
                if e <= t_f:
                    break
                span = e - t_f
                if v3:
                    # Measured vowel space (Peterson-Barney) with +-5%
                    # per-token scatter instead of uniform-random draws.
                    f1, f2, f3 = pb[rng.integers(len(pb))] * rng.uniform(
                        0.95, 1.05, 3
                    )
                else:
                    f1 = rng.uniform(260.0, 850.0)
                    f2 = rng.uniform(f1 + 300.0, 2350.0)
                    f3 = rng.uniform(max(f2 + 350.0, 2300.0), 3200.0)
                if rich and rng.uniform() < 0.35:
                    # Diphthong: glide to a second target across the
                    # nucleus (real vowels move; v1's are stationary).
                    if v3:
                        f1b, f2b, _ = pb[rng.integers(len(pb))] * rng.uniform(
                            0.95, 1.05, 3
                        )
                    else:
                        f1b = rng.uniform(260.0, 850.0)
                        f2b = rng.uniform(f1b + 300.0, 2350.0)
                    t1 = np.linspace(f1, f1b, span)
                    t2 = np.linspace(f2, f2b, span)
                else:
                    t1 = np.full(span, f1)
                    t2 = np.full(span, f2)
                if v3 and locus is not None:
                    # Coarticulation: glide the first third of the vowel
                    # from the onset consonant's locus to the target.
                    k = max(2, int(0.33 * span))
                    if k <= span:
                        ramp = np.linspace(0.0, 1.0, k)
                        t1[:k] = locus[0] * (1.0 - ramp) + t1[:k] * ramp
                        t2[:k] = locus[1] * (1.0 - ramp) + t2[:k] * ramp
                F[t_f:e, 0] = t1 * f_shift
                F[t_f:e, 1] = t2 * f_shift
                F[t_f:e, 2] = f3 * f_shift
                F[t_f:e, 3] = rng.uniform(3400.0, 4000.0) * f_shift
                voiced[t_f:e] = 1.0
                # Attack / decay inside the syllable.
                env = np.ones(e - t_f)
                a = min(3, len(env))
                env[:a] = np.linspace(0.3, 1.0, a)
                env[-1] = 0.5
                gain[t_f:e] = rng.uniform(0.45, 1.0) * env
                if rich and rng.uniform() < 0.25:
                    accents.append((t_f, e))
                phrase_len_est = t_f + dur - phrase_start
                t_f = e
            # Declination over the phrase.
            pe = min(n_frames, phrase_start + max(phrase_len_est, 1))
            decl = np.linspace(1.12, 0.85, pe - phrase_start)
            f0[phrase_start:pe] = f0_base * decl

        # Accented syllables ride an f0 excursion on top of declination.
        for (s, e) in accents:
            f0[s:e] *= rng.uniform(1.08, 1.25)

        # Smooth everything that must move continuously (formants glide
        # through consonants; gain/voicing have soft edges).
        def smooth(x, w):
            k = np.hanning(w)
            k /= k.sum()
            return np.convolve(x, k, mode="same")

        for j in range(4):
            F[:, j] = smooth(F[:, j], 9)
        voiced = np.clip(smooth(voiced, 5), 0.0, 1.0)
        gain = smooth(gain, 5)
        fric = smooth(fric, 3)
        f0 = smooth(f0, 7) * (1.0 + 0.01 * rng.standard_normal(n_frames))
        return voiced, gain, fric, fric_freq, f0, F, nasal

    # -- synthesis ----------------------------------------------------------

    def _synthesize(self, rng):
        from scipy.signal import lfilter

        sr = self.sample_rate
        n = self.max_samples
        rich = self.variant in ("v2", "v3")
        v3 = self.variant == "v3"
        voiced, gain, fric, fric_freq, f0, F, nasal = self._build_tracks(rng)
        n_frames = len(voiced)

        # Per-sample source tracks.
        up = lambda x: np.repeat(x, self.FRAME)[:n]  # noqa: E731
        f0_s = up(f0)
        voiced_s = up(voiced)
        gain_s = up(gain)

        # Glottal source: sawtooth rounded by a one-pole lowpass (~-12
        # dB/oct, Klatt-style glottal tilt; the later +6 dB/oct radiation
        # nets the classic -6 dB/oct speech slope) + aspiration noise.
        phase = np.cumsum(f0_s) / sr
        saw = 2.0 * (phase % 1.0) - 1.0
        saw = lfilter([0.06], [1.0, -0.94], saw)
        # Per-speaker breathiness in v2 (v1: fixed 0.02).
        asp_level = rng.uniform(0.01, 0.06) if rich else 0.02
        aspiration = asp_level * rng.standard_normal(n)
        source = voiced_s * gain_s * (saw + aspiration)

        # Cascade formant filtering with frame-wise constant biquads.
        bw = np.array([80.0, 110.0, 160.0, 220.0])  # formant bandwidths (Hz)
        r = np.exp(-np.pi * bw / sr)  # (4,)
        if rich:
            # Nasal anti-resonance: a unit-DC-gain notch applied during
            # nasal murmurs (the spectral zero vowels lack).
            fz = rng.uniform(750.0, 1100.0)
            tz = 2.0 * np.pi * fz / sr
            rz = 0.93
            a_nz = np.array([1.0, -2.0 * rz * np.cos(tz), rz * rz])
            k_nz = a_nz.sum() / (2.0 - 2.0 * np.cos(tz))
            b_nz = k_nz * np.array([1.0, -2.0 * np.cos(tz), 1.0])
            zi_nz = np.zeros(2)
        voiced_path = np.zeros(n)
        state = np.zeros((4, 2))
        for i in range(n_frames):
            s0, s1 = i * self.FRAME, min((i + 1) * self.FRAME, n)
            if s1 <= s0:
                break
            seg = source[s0:s1]
            for j in range(4):
                theta = 2.0 * np.pi * F[i, j] / sr
                a = np.array([1.0, -2.0 * r[j] * np.cos(theta), r[j] * r[j]])
                b = np.array([1.0 - r[j]])
                seg, state[j] = lfilter(b, a, seg, zi=state[j])
            if rich and nasal[i] > 0.5:
                seg, zi_nz = lfilter(b_nz, a_nz, seg, zi=zi_nz)
            voiced_path[s0:s1] = seg

        # Fricatives / bursts: noise through a single wide resonator.
        fr_gain = up(fric)
        noise_path = np.zeros(n)
        if np.any(fr_gain > 0):
            noise = rng.standard_normal(n)
            shaped = np.zeros(n)
            zi = np.zeros(2)
            rr = np.exp(-np.pi * 900.0 / sr)
            for i in range(n_frames):
                s0, s1 = i * self.FRAME, min((i + 1) * self.FRAME, n)
                if s1 <= s0:
                    break
                theta = 2.0 * np.pi * min(fric_freq[i], 0.45 * sr) / sr
                a = np.array([1.0, -2.0 * rr * np.cos(theta), rr * rr])
                shaped[s0:s1], zi = lfilter(
                    np.array([1.0 - rr]), a, noise[s0:s1], zi=zi
                )
            noise_path = fr_gain * shaped

        # Lip radiation (+6 dB/oct, with a flat leak) is applied per path
        # BEFORE level normalization -- applying it to the mix would boost
        # the high-frequency noise path ~20 dB relative to the vowels.
        def radiate(x):
            return np.diff(x, prepend=0.0) + 0.15 * x

        voiced_path = radiate(voiced_path)
        noise_path = radiate(noise_path)

        # The two paths come out of their filters at wildly different
        # levels; normalize each over its active region, then mix with
        # consonants well below the vowels (real long-term speech spectra
        # sit ~16 dB down by 2-4 kHz; validated against the bundled eval
        # clips in tests).
        def active_rms(x, active):
            sel = x[active] if np.any(active) else x
            return float(np.sqrt(np.mean(sel**2))) + 1e-12

        out = voiced_path / active_rms(voiced_path, voiced_s > 0.5)
        out = out + 0.13 * noise_path / active_rms(noise_path, fr_gain > 0.05)

        if v3:
            # Room reverberation: direct path + pre-delay + exponentially
            # decaying noise tail (RT60 0.12-0.5 s), energy set by a
            # direct-to-reverb ratio of 3-12 dB.
            if rng.uniform() < 0.5:
                rt60 = rng.uniform(0.12, 0.5)
                pre = int(rng.uniform(0.002, 0.008) * sr)
                L = int(0.8 * rt60 * sr)
                tail = rng.standard_normal(L) * np.exp(
                    -6.908 * np.arange(L) / (rt60 * sr)
                )
                drr = 10.0 ** (-rng.uniform(3.0, 12.0) / 20.0)
                tail *= drr / (np.sqrt(np.sum(tail**2)) + 1e-12)
                rir = np.concatenate([[1.0], np.zeros(pre), tail])
                from scipy.signal import fftconvolve

                out = fftconvolve(out, rir)[:n]
            sig_rms = float(np.sqrt(np.mean(out**2))) + 1e-12
            # Short band-limited noise events (thumps, page turns).
            if rng.uniform() < 0.45:
                for _ in range(int(rng.integers(1, 4))):
                    dur = int(rng.uniform(0.05, 0.30) * sr)
                    t0 = int(rng.integers(0, max(1, n - dur)))
                    burst = rng.standard_normal(dur)
                    if rng.uniform() < 0.6:
                        bfc = rng.uniform(150.0, 4000.0)
                        bbw = rng.uniform(200.0, 1200.0)
                        rr_b = np.exp(-np.pi * bbw / sr)
                        th = 2.0 * np.pi * bfc / sr
                        burst = lfilter(
                            [1.0 - rr_b],
                            [1.0, -2.0 * rr_b * np.cos(th), rr_b * rr_b],
                            burst,
                        )
                    burst *= np.hanning(dur) ** 0.5
                    local_snr = rng.uniform(10.0, 25.0)
                    lvl = sig_rms * 10.0 ** (-local_snr / 20.0)
                    burst *= lvl / (np.sqrt(np.mean(burst**2)) + 1e-12)
                    out[t0:t0 + dur] += burst
            # Steady background noise floor.
            if rng.uniform() < 0.35:
                snr = rng.uniform(25.0, 40.0)
                out = out + rng.standard_normal(n) * sig_rms * 10.0 ** (
                    -snr / 20.0
                )

        # Recording noise floor + robust normalization (99.9th-percentile
        # scale so one plosive burst cannot crush the vowels).
        out += 2e-4 * rng.standard_normal(n)
        scale = np.quantile(np.abs(out), 0.999) + 1e-9
        out = np.clip(out / scale, -1.0, 1.0)
        return (out * rng.uniform(0.6, 0.95)).astype(np.float32)

    def __getitem__(self, idx: int) -> np.ndarray:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        path = self._disk_path(idx)
        if path is not None and path.exists():
            item = np.load(path)
        else:
            # v1 keeps the original hash string so committed checkpoints
            # remain exactly reproducible.
            key = (
                f"formant:{self.seed}:{idx}"
                if self.variant == "v1"
                else f"formant:{self.variant}:{self.seed}:{idx}"
            )
            rng = np.random.default_rng(
                int.from_bytes(
                    hashlib.blake2s(key.encode(), digest_size=8).digest(),
                    "little",
                )
            )
            item = self._synthesize(rng)
            if path is not None:
                tmp = path.with_suffix(".tmp.npy")
                np.save(tmp, item)
                os.replace(tmp, path)  # atomic for concurrent readers
        if self._cache is not None:
            self._cache[idx] = item
        return item

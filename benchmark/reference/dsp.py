"""Plain signal processing of both families, frozen here as the yardstick's
own copy: the STFT and its inverse, gap masks, the phase-vocoder
extrapolation of a gap's phase, and PCM16.

Plain PyTorch, written from the definitions the served and trained paths
state (periodic Hann window zero-padded centrally to ``n_fft``; ``center``
pads the signal with zeros; the inverse divides by the window's sum-square
where it is above ``finfo.tiny``; PCM16 is ``round(x * 32767)`` clipped).
Nothing here imports the program, so a change to the program's DSP cannot
move what it is held to.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PCM_SCALE = 32767.0


def hann(win_length: int, n_fft: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The periodic Hann window of ``win_length`` samples, zero-padded to
    ``n_fft`` with its centre at ``n_fft // 2``."""
    n = torch.arange(win_length, dtype=torch.float64, device=device)
    win = (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)).to(dtype)
    left = (n_fft - win_length) // 2
    return F.pad(win, (left, n_fft - win_length - left))


def stft(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """``(B, S)`` -> complex ``(B, n_fft // 2 + 1, 1 + S // hop)``."""
    win = hann(win_length, n_fft, y.dtype, y.device)
    y = F.pad(y, (n_fft // 2, n_fft // 2))
    frames = y.unfold(-1, n_fft, hop_length)
    return torch.fft.rfft(frames * win, n=n_fft, dim=-1).transpose(-1, -2)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
          length: int) -> torch.Tensor:
    """Complex ``(B, F, N)`` -> ``(B, length)``: windowed overlap-add over the
    window's sum-square."""
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    win = hann(win_length, n_fft, frames.dtype, frames.device)
    frames = frames * win
    b, n = frames.shape[0], frames.shape[1]
    total = n_fft + hop_length * (n - 1)

    def overlap_add(x):  # (b, n, n_fft) -> (b, total)
        return F.fold(x.transpose(1, 2), output_size=(1, total), kernel_size=(1, n_fft),
                      stride=(1, hop_length)).reshape(x.shape[0], total)

    out = overlap_add(frames)
    wss = overlap_add((win * win).expand(1, n, n_fft))[0]
    ok = wss > torch.finfo(frames.dtype).tiny
    out = torch.where(ok, out / torch.where(ok, wss, torch.ones_like(wss)), out)
    start = n_fft // 2
    out = out[:, start:start + length]
    return F.pad(out, (0, length - out.shape[-1])) if out.shape[-1] < length else out


def gap_mask(n: int, start: torch.Tensor, length: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``(B, n)``: 0 on ``[start, start + length)`` of each row, 1 elsewhere;
    ``start`` and ``length`` may carry a trailing axis of several gaps."""
    idx = torch.arange(n, device=start.device)
    if start.ndim == 1:
        start, length = start[:, None], length[:, None]
    inside = (idx >= start[..., None]) & (idx < (start + length)[..., None])
    return (~inside.any(dim=-2)).to(dtype)


def hole_frames_interval(start: torch.Tensor, end: torch.Tensor, n_frames: int,
                         hop: int) -> torch.Tensor:
    """``(B, N)`` bool: frames ``[start // hop, ceil(end / hop))`` of each
    row's interval (the GAN's rule); ``start``/``end`` may carry a trailing
    axis of several gaps, a frame then being a hole for any of them."""
    t = torch.arange(n_frames, device=start.device)
    if start.ndim == 1:
        start, end = start[:, None], end[:, None]
    lo, hi = start // hop, -((-end) // hop)
    hole = (t >= lo[..., None]) & (t < hi[..., None]) & (end > start)[..., None]
    return hole.any(dim=-2)


def hole_frames_end_rule(sample_valid: torch.Tensor, n_frames: int, hop: int) -> torch.Tensor:
    """``(..., N)`` bool: frame ``t`` is a hole when sample ``t * hop + hop -
    1`` is missing (the CNN+BiLSTM's rule); samples past the clip count as
    present."""
    idx = torch.arange(n_frames, device=sample_valid.device) * hop + hop - 1
    n = sample_valid.shape[-1]
    inside = idx < n
    vals = sample_valid[..., idx.clamp(max=n - 1)]
    return (vals < 0.5) & inside


def phase_of(spec: torch.Tensor) -> torch.Tensor:
    """``angle(spec)``, 0 where ``spec`` is exactly 0."""
    return torch.where(spec == 0, torch.zeros((), dtype=spec.real.dtype, device=spec.device),
                       torch.atan2(spec.imag, spec.real))


def window_clear(sample_valid: torch.Tensor, n_frames: int, hop: int, win_length: int) -> torch.Tensor:
    """``(B, N)`` bool: frame ``t``'s analysis window ``[t * hop - wl // 2, t *
    hop + wl - wl // 2)`` holds no missing sample (outside the clip counts
    as present)."""
    missing = (sample_valid < 0.5).to(torch.int64)
    c = F.pad(torch.cumsum(missing, dim=-1), (1, 0))
    s = sample_valid.shape[-1]
    centre = torch.arange(n_frames, device=sample_valid.device) * hop
    lo = torch.clamp(centre - win_length // 2, 0, s)
    hi = torch.clamp(centre + win_length - win_length // 2, 0, s)
    return (c[:, hi] - c[:, lo]) == 0


def princarg(x: torch.Tensor) -> torch.Tensor:
    return x - 2.0 * math.pi * torch.round(x / (2.0 * math.pi))


def extrapolate_phase(phase: torch.Tensor, trusted: torch.Tensor, hop: int,
                      n_fft: int) -> torch.Tensor:
    """Each untrusted frame's phase from the trusted frames on either side:
    a bin's advance a hop measured on the two trusted frames at that side's
    boundary (``omega + princarg(dphi - omega)``, ``omega = 2 pi f hop /
    n_fft``; ``omega`` alone where the second frame is missing or not
    trusted), carried linearly from each side and blended on the unit
    circle with a cos^2 crossfade; a side with no trusted frame weighs 0;
    where the blend cancels exactly the phase is 0."""
    b, n_bins, n = phase.shape
    dev, dt = phase.device, phase.dtype
    t = torch.arange(n, device=dev)
    lv = torch.cummax(torch.where(trusted, t, -1), dim=1).values  # last trusted <= t
    rv = torch.cummin(torch.where(trusted, t, n).flip(1), dim=1).values.flip(1)  # first >= t

    def at(i):  # (B, F, N) phase at frame i (B, N)
        return torch.gather(phase, 2, i.clamp(0, n - 1)[:, None, :].expand(b, n_bins, n))

    def ok(i):
        return ((i >= 0) & (i <= n - 1) & torch.gather(trusted, 1, i.clamp(0, n - 1)))[:, None]

    omega = (2.0 * math.pi * hop / n_fft) * torch.arange(n_bins, device=dev, dtype=dt)[None, :, None]
    d_left = torch.where(ok(lv - 1), princarg(at(lv) - at(lv - 1) - omega) + omega, omega)
    d_right = torch.where(ok(rv + 1), princarg(at(rv + 1) - at(rv) - omega) + omega, omega)
    ext_l = at(lv) + (t - lv).clamp(min=0)[:, None] * d_left
    ext_r = at(rv) - (rv - t).clamp(min=0)[:, None] * d_right
    has_l, has_r = (lv >= 0)[:, None], (rv <= n - 1)[:, None]
    span = (rv - lv).clamp(min=1)[:, None]
    w = ((rv[:, None] - t) / span).to(dt)
    w_l = torch.where(has_l, torch.sin(0.5 * math.pi * w) ** 2, torch.zeros((), dtype=dt, device=dev))
    w_l = torch.where(has_r, w_l, has_l.to(dt))
    w_r = torch.where(has_r, 1.0 - w_l, torch.zeros((), dtype=dt, device=dev))
    re = w_l * torch.cos(ext_l) + w_r * torch.cos(ext_r)
    im = w_l * torch.sin(ext_l) + w_r * torch.sin(ext_r)
    ext = torch.where(torch.hypot(re, im) < 1e-12, torch.zeros((), dtype=dt, device=dev),
                      torch.atan2(im, re))
    return torch.where(trusted[:, None], phase, ext)


def pcm16(x: torch.Tensor) -> torch.Tensor:
    """Float samples to int16: ``round(x * 32767)`` (half to even), clipped."""
    return torch.clamp(torch.round(x * PCM_SCALE), -32768.0, 32767.0).to(torch.int16)


def patch_of(audio: torch.Tensor, sample_valid: torch.Tensor, rebuilt: torch.Tensor,
             gap_start: torch.Tensor, window: int):
    """The deliverable of a served request: the clip composited in time (the
    input outside the gap, ``rebuilt`` inside), ``window`` samples of it
    from ``clamp(gap_start, 0, S - window)``, as PCM16; and that start."""
    s = audio.shape[-1]
    clip = audio * sample_valid + rebuilt * (1.0 - sample_valid)
    start = torch.clamp(gap_start, 0, s - window)
    idx = start[:, None] + torch.arange(window, device=audio.device)
    return pcm16(torch.gather(clip, 1, idx)), start

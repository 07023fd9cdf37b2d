"""Classical AR benchmark grid, the reference's ``models/AudioReg/train.m``
script (port of ``ml_audio_inpainting_tpu/cli/ar_benchmark.py``)::

    python -m ml_audio_inpainting_torch.cli.ar_benchmark \\
        --input results/formant_corpus_samples --output-dir ar_results \\
        [--orders 256 512 --estimators lpc --device cpu]

For each gap length, AR order and estimator (``train.m:13-15``), the clips
are restored by five methods: forward/backward extrapolation, gap-wise
Janssen (its gap SDR after every iteration), and overlap-add Janssen with
hann, rect and tukey windows (``train.m:131-174``); each method runs as
batched solves of ``--chunk`` clips on ``--device`` (``cuda`` unless the
caller asks for ``cpu``).  Each grid point is written to
``results_p<p>_<estimator>_gap<ms>ms.json`` in the JAX CLI's layout (wall
seconds, gap SDR and fwSegSNR a clip), and a file that exists is skipped
(resume).  There is no default clip set: ``--input`` is required.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["METHODS", "build_argparser", "main"]

METHODS = ("extrapolation", "janssen", "janssen_hann", "janssen_rect", "janssen_tukey")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Classical AR benchmark grid (train.m)")
    p.add_argument("--input", required=True, help="audio file or directory")
    p.add_argument("--output-dir", default="./ar_results")
    p.add_argument("--orders", type=int, nargs="+", default=[256, 512, 1024, 2048, 3072])
    p.add_argument("--estimators", nargs="+", default=["arburg", "lpc"])
    p.add_argument("--gap-lens-ms", type=int, nargs="+", default=[80])
    p.add_argument("--gap-start", type=float, default=2.0)
    p.add_argument("--maxit", type=int, default=10)
    p.add_argument("--w", type=int, default=4096, help="OLA window (train.m:31)")
    p.add_argument("--a", type=int, default=1024, help="OLA shift (train.m:32)")
    p.add_argument("--resume", action="store_true", default=True)
    p.add_argument("--chunk", type=int, default=3,
                   help="clips per batched solve (bounds device memory for the windowed "
                        "methods)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _rounded(values: torch.Tensor) -> list:
    return [round(float(v), 3) for v in values.cpu()]


def main(argv=None) -> None:
    from ml_audio_inpainting_torch.classical.arinpaint import arinpaint
    from ml_audio_inpainting_torch.classical.janssen import janssen
    from ml_audio_inpainting_torch.classical.ola import segmentation_inpaint
    from ml_audio_inpainting_torch.cli.inpaint import _collect
    from ml_audio_inpainting_torch.data.audio_io import load_audio
    from ml_audio_inpainting_torch.ops.gaps import gap_mask
    from ml_audio_inpainting_torch.train.metrics import fwseg_snr, gap_sdr

    args = build_argparser().parse_args(argv)
    device = args.device
    outdir = Path(args.output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    files = _collect(Path(args.input))
    sr = 16000
    clean = torch.from_numpy(
        np.stack([load_audio(f, sample_rate=sr, max_len=5.0)[0] for f in files])).to(device)
    B, n = clean.shape

    def chunked(solver, *tensors):
        """``solver`` on ``--chunk`` clips at a time, concatenated."""
        return torch.cat([solver(*(t[i : i + args.chunk] for t in tensors))
                          for i in range(0, B, args.chunk)])

    for gap_ms in args.gap_lens_ms:
        gap_len = int(gap_ms * sr / 1000)
        max_gap = 1 << (gap_len - 1).bit_length()
        gs = torch.full((B,), int(args.gap_start * sr), dtype=torch.int64, device=device)
        gl = torch.full((B,), gap_len, dtype=torch.int64, device=device)
        tmask = gap_mask(n, gs, gl)
        gapped = clean * tmask
        gapm = 1.0 - tmask

        for p_order in args.orders:
            for est in args.estimators:
                out_path = outdir / f"results_p{p_order}_{est}_gap{gap_ms}ms.json"
                if args.resume and out_path.exists():
                    print(f"skip (resume): {out_path}")
                    continue
                entry = {
                    "p": p_order, "estimator": est, "gap_ms": gap_ms,
                    "maxit": args.maxit, "w": args.w, "a": args.a,
                    "signals": [f.name for f in files], "methods": {},
                }

                def record(name, restored_fn):
                    _sync(device)
                    t0 = time.perf_counter()
                    restored = restored_fn()
                    _sync(device)
                    elapsed = time.perf_counter() - t0
                    m = {
                        "time_s": round(elapsed, 3),
                        "gap_sdr_db": _rounded(gap_sdr(clean, restored, gapm)),
                        "fwseg_snr_db": _rounded(fwseg_snr(clean, restored)),
                    }
                    entry["methods"][name] = m
                    print(f"p={p_order} {est} gap={gap_ms}ms {name}: "
                          f"SDR {np.mean(m['gap_sdr_db']):.2f} dB ({elapsed:.1f}s)")

                record("extrapolation", lambda: chunked(
                    lambda x, mm, s, l: arinpaint(x, mm, s, l, order=p_order, context=args.w,
                                                  max_gap=max_gap, method=est),
                    gapped, tmask, gs, gl))

                # Gap-wise Janssen, every iteration's solution (train.m's "saveall").
                ctx = args.w
                pad = ctx + max_gap
                seg_len = 2 * ctx + max_gap

                def gapwise_saveall(x, mm, s, l):
                    xp = F.pad(x, (pad, pad))
                    mp = F.pad(mm, (pad, pad), value=1.0)
                    st = (s - ctx + pad).clamp(0, xp.shape[-1] - seg_len)
                    idx = st[:, None] + torch.arange(seg_len, device=device)
                    hist = janssen(xp.gather(-1, idx), mp.gather(-1, idx),
                                   torch.full_like(s, ctx), l, p=p_order, maxit=args.maxit,
                                   method=est, max_gap=max_gap, saveall=True)  # (b, maxit, seg)
                    idx = idx[:, None].expand(hist.shape)
                    return xp[:, None].expand(-1, args.maxit, -1).scatter(
                        -1, idx, hist)[..., pad : pad + n]  # (b, maxit, n)

                _sync(device)
                t0 = time.perf_counter()
                hist = chunked(gapwise_saveall, gapped, tmask, gs, gl)
                _sync(device)
                elapsed = time.perf_counter() - t0
                per_iter = gap_sdr(clean[:, None], hist, gapm[:, None])  # (B, maxit)
                final = hist[:, -1]
                entry["methods"]["janssen"] = {
                    "time_s": round(elapsed, 3),
                    "gap_sdr_db": _rounded(gap_sdr(clean, final, gapm)),
                    "fwseg_snr_db": _rounded(fwseg_snr(clean, final)),
                    "gap_sdr_per_iter_db": [_rounded(row) for row in per_iter],
                }
                print(f"p={p_order} {est} gap={gap_ms}ms janssen: SDR "
                      f"{np.mean(entry['methods']['janssen']['gap_sdr_db']):.2f} dB "
                      f"({elapsed:.1f}s)")

                for wtype in ("hann", "rect", "tukey"):
                    record(f"janssen_{wtype}", lambda wt=wtype: chunked(
                        lambda x, mm, s, l: segmentation_inpaint(
                            x, mm, s, l, p=p_order, maxit=args.maxit, method=est, wtype=wt,
                            w=args.w, a=args.a, max_gap=max_gap),
                        gapped, tmask, gs, gl))

                out_path.write_text(json.dumps(entry, indent=1))
                print(f"wrote {out_path}")


if __name__ == "__main__":
    main()

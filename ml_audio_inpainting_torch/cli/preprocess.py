"""Corpus preprocessing CLI: one gap a file over a dataset tree (port of
``ml_audio_inpainting_tpu/cli/preprocess.py``)::

    python -m ml_audio_inpainting_torch.cli.preprocess --input corpus/ \\
        --output corpus_PROCESSED/ --gap-len 0.1 [--gap-start 0.5] [--device cpu]

Every audio file under ``--input`` (``data/dataset.py::list_audio_files``;
or the one file given) is read at ``--sample-rate``, cut or padded to
``--max-len`` seconds, and gets one gap of ``int(gap_len * sample_rate)``
zeros, at ``--gap-start`` or uniform over the clip
(``ops/gaps.py::random_gap_mask``); the tree is mirrored under
``--output`` as 16-bit FLAC, the samples written as they are (no peak
normalisation).  A batch of ``--batch-size`` files is gapped in one
product on ``--device``.

The random starts come from a ``torch.Generator`` seeded ``--seed``, a
batch's in one draw on the CPU; the JAX CLI draws them from
``jax.random.PRNGKey(seed)``, so the two place the gaps differently.  A
fixed ``--gap-start`` gives the JAX CLI's files bit for bit.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List

import numpy as np
import torch

__all__ = ["build_argparser", "main"]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Insert gaps into a corpus")
    p.add_argument("--input", required=True, help="corpus root (or one file)")
    p.add_argument("--output", required=True, help="mirrored output root (or file)")
    p.add_argument("--gap-len", type=float, default=0.1, help="seconds (reference default)")
    p.add_argument("--gap-start", type=float, default=None,
                   help="fixed start (s); random when omitted")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--max-len", type=float, default=5.0)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def main(argv=None) -> List[Path]:
    """Run the CLI; returns the files written, in the input's order."""
    from ml_audio_inpainting_torch.data.audio_io import load_audio, save_audio
    from ml_audio_inpainting_torch.data.dataset import list_audio_files
    from ml_audio_inpainting_torch.ops.gaps import random_gap_mask

    args = build_argparser().parse_args(argv)
    inp, out = Path(args.input), Path(args.output)
    files = list_audio_files(inp) if inp.is_dir() else [inp]
    n_samples = int(args.sample_rate * args.max_len)
    gen = torch.Generator().manual_seed(args.seed)

    written = []
    for i in range(0, len(files), args.batch_size):
        chunk = files[i : i + args.batch_size]
        audio = np.stack([load_audio(f, sample_rate=args.sample_rate, max_len=args.max_len)[0]
                          for f in chunk])
        masks, _ = random_gap_mask(gen, n_samples, args.gap_len, args.sample_rate,
                                   gap_start_s=args.gap_start, shape=(len(chunk),),
                                   device=args.device)
        gapped = (torch.from_numpy(audio).to(args.device) * masks).cpu().numpy()
        for j, f in enumerate(chunk):
            dest = (out / f.relative_to(inp)) if inp.is_dir() else out
            save_audio(gapped[j], dest, args.sample_rate, normalize=False)
            written.append(dest)
        print(f"{len(written)}/{len(files)}", end="\r")
    print(f"\nprocessed {len(written)} files -> {out}")
    return written


if __name__ == "__main__":
    main()

"""Evaluation gaps-table CLI (port of
``ml_audio_inpainting_tpu/cli/build_gaps_table.py``)::

    python -m ml_audio_inpainting_torch.cli.build_gaps_table --input clips/ \\
        --output gaps_table.json [--mode multi --write-audio gapped/] [--device cpu]

``--mode fixed`` writes the table of ``create_librispeech_dataset.m``: one
gap a requested length (``--gap-lens-ms``) at ``--gap-start`` a file.
``--mode multi`` writes the IRMAS-style table (``IRMAS_gaps.m``):
``--n-gaps`` gaps a file of ``--min-gap-ms`` to ``--max-gap-ms``, at least
``--min-dist`` samples apart and from either edge
(``data/multigap.py::multi_gap_layout``).  The JSON holds the gaps as
``[start, length]`` intervals and the recipe that rebuilds the masks
(``read_recipe``), under the JAX CLI's keys.  ``--write-audio DIR`` also
writes each file with its gaps zeroed, in ``multi`` mode with cos^2 fades
of ``--fade-len`` samples outside each gap (``apply_gaps_with_fades``),
as ``{stem}_gapped.flac`` (16-bit, no peak normalisation); the gapping runs
on ``--device``.

``--input`` is required (the JAX CLI's default is a directory of the
reference's samples).  The ``multi`` layouts come from a
``torch.Generator`` seeded ``--seed``, one file after another
(``random_multi_gap_layout``); the JAX CLI draws them from
``jax.random.PRNGKey(seed)``, so the two tables place the gaps
differently.  ``fixed`` mode gives the JAX CLI's table and files.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

__all__ = ["build_argparser", "main", "READ_RECIPE"]

READ_RECIPE = ("mask[i] reconstructs as: ones(n_samples); for (s, l) in "
               "entries[i]['gaps']: mask[s:s+l] = 0")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Build an eval gaps table")
    p.add_argument("--input", required=True, help="directory of clips (or one file)")
    p.add_argument("--output", default="gaps_table.json")
    p.add_argument("--write-audio", type=str, default=None,
                   help="also write gapped FLACs to this directory")
    p.add_argument("--mode", choices=["fixed", "multi"], default="fixed")
    # fixed mode (create_librispeech_dataset.m:18-20)
    p.add_argument("--gap-lens-ms", type=int, nargs="+", default=[80])
    p.add_argument("--gap-start", type=float, default=2.0)
    # multi mode (IRMAS_gaps.m)
    p.add_argument("--n-gaps", type=int, default=10)
    p.add_argument("--min-gap-ms", type=float, default=10.0)
    p.add_argument("--max-gap-ms", type=float, default=80.0)
    p.add_argument("--min-dist", type=int, default=4096, help="samples between gaps")
    p.add_argument("--fade-len", type=int, default=32, help="cos^2 fade samples (0 = hard)")
    p.add_argument("--max-len", type=float, default=5.0)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns the table it wrote."""
    from ml_audio_inpainting_torch.cli.inpaint import _collect
    from ml_audio_inpainting_torch.data.audio_io import load_audio, save_audio
    from ml_audio_inpainting_torch.data.multigap import (
        apply_gaps_with_fades,
        gaps_mask,
        random_multi_gap_layout,
    )

    args = build_argparser().parse_args(argv)
    files = _collect(Path(args.input))
    sr = args.sample_rate
    n = int(sr * args.max_len)
    table = {"sample_rate": sr, "n_samples": n, "mode": args.mode, "read_recipe": READ_RECIPE,
             "entries": []}
    gen = torch.Generator().manual_seed(args.seed)

    for f in files:
        entry = {"file": f.name}
        if args.mode == "fixed":
            gs = int(args.gap_start * sr)
            gaps_by_len = {str(ms): [[gs, int(ms * sr / 1000)]] for ms in args.gap_lens_ms}
            entry["gaps_by_len_ms"] = gaps_by_len
            entry["gaps"] = gaps_by_len[str(args.gap_lens_ms[0])]
        else:
            starts, lengths = random_multi_gap_layout(
                gen, (), n, args.n_gaps, min_gap_ms=args.min_gap_ms,
                max_gap_ms=args.max_gap_ms, sample_rate=sr, min_dist_samples=args.min_dist)
            entry["gaps"] = [[s, l] for s, l in zip(starts.tolist(), lengths.tolist())]
        table["entries"].append(entry)

        if args.write_audio:
            audio = torch.from_numpy(load_audio(f, sample_rate=sr, max_len=args.max_len)[0])
            audio = audio.to(args.device)
            starts = torch.tensor([g[0] for g in entry["gaps"]], device=args.device)
            lengths = torch.tensor([g[1] for g in entry["gaps"]], device=args.device)
            if args.fade_len > 0 and args.mode == "multi":
                gapped = apply_gaps_with_fades(audio, starts, lengths, fade_len=args.fade_len)
            else:
                gapped = audio * gaps_mask(n, starts, lengths)
            save_audio(gapped, Path(args.write_audio) / f"{f.stem}_gapped.flac", sr,
                       normalize=False)

    Path(args.output).write_text(json.dumps(table, indent=1))
    print(f"wrote {args.output} ({len(table['entries'])} entries)")
    return table


if __name__ == "__main__":
    main()

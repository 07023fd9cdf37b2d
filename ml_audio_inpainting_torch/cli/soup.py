"""Weight-space model soup: average exported npz checkpoints (port of
``ml_audio_inpainting_tpu/cli/soup.py``)::

    python -m ml_audio_inpainting_torch.cli.soup out.npz a.npz b.npz --weights 0.25 0.75

Two or more :func:`~ml_audio_inpainting_torch.train.checkpoints.export_params_npz`
files of the same architecture (probe-selected steps of one run, or sibling
seeds) become one deployable checkpoint that ``--checkpoint`` takes in
``inpaint``/``evaluate``.  Every floating array is averaged (parameters and
BatchNorm statistics: the means of a convex combination are the mixture's);
the files must hold the same keys and shapes, or it aborts.  It runs on the
host in numpy, in the JAX function's order, so its output is JAX's bit for
bit.
"""

from __future__ import annotations

import argparse
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

__all__ = ["build_argparser", "soup_params", "main"]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Average npz checkpoints (model soup)")
    p.add_argument("output", help="destination .npz")
    p.add_argument("inputs", nargs="+", help="two or more source .npz")
    p.add_argument("--weights", type=float, nargs="+", default=None,
                   help="convex weights, one per input (default: uniform); normalized to sum "
                        "to 1")
    p.add_argument("--dtype", choices=["float16", "float32"], default="float16",
                   help="export dtype (float16 = the commit-friendly default)")
    return p


def soup_params(trees: Sequence[Mapping[str, np.ndarray]],
                weights: Optional[Sequence[float]] = None) -> Dict[str, np.ndarray]:
    """The weighted average of flat variable dicts of one structure: floating
    arrays averaged (``sum(w_i * x_i)`` in input order), other arrays
    identical across the inputs and passed through.  Refuses fewer than two
    inputs, a count of weights other than the inputs', a negative weight,
    weights that do not sum to more than 0, another structure or shape, and
    non-float arrays that differ."""
    if len(trees) < 2:
        raise ValueError("need at least two checkpoints to soup")
    n = len(trees)
    if weights is None:
        weights = [1.0 / n] * n
    if len(weights) != n:
        raise ValueError(f"{len(weights)} weights for {n} inputs")
    if any(x < 0 for x in weights):
        # Averaged BatchNorm variances stay non-negative only for convex weights.
        raise ValueError("weights must be non-negative (convex soup)")
    total = float(sum(weights))
    if total <= 0:
        raise ValueError("weights must sum to a positive value")
    w = [float(x) / total for x in weights]
    keys = sorted(trees[0])
    if any(sorted(t) != keys for t in trees[1:]):
        raise ValueError("checkpoint trees differ in structure; soup requires the same "
                         f"architecture export ({keys} vs {[sorted(t) for t in trees[1:]]})")
    out = {}
    for key in keys:
        leaves = [t[key] for t in trees]
        first = np.asarray(leaves[0])
        if not np.issubdtype(first.dtype, np.floating):
            if any(not np.array_equal(first, np.asarray(other)) for other in leaves[1:]):
                raise ValueError("non-float leaves differ across inputs")
            out[key] = leaves[0]
            continue
        shapes = {np.asarray(leaf).shape for leaf in leaves}
        if len(shapes) != 1:
            raise ValueError(f"leaf shape mismatch across inputs: {shapes}")
        out[key] = sum(wi * li for wi, li in zip(w, leaves))
    return out


def main(argv=None) -> None:
    from ml_audio_inpainting_torch.weights import load_params_npz

    args = build_argparser().parse_args(argv)
    trees = [load_params_npz(p) for p in args.inputs]
    out = soup_params(trees, args.weights)
    if args.dtype == "float16":
        out = {k: v.astype("float16") if v.dtype == np.float32 else v for k, v in out.items()}
    np.savez_compressed(args.output, **out)
    print(f"souped {len(trees)} checkpoints -> {args.output}")


if __name__ == "__main__":
    main()

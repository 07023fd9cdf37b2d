"""Plot the classical benchmark's results (port of
``ml_audio_inpainting_tpu/cli/ar_plots.py``)::

    python -m ml_audio_inpainting_torch.cli.ar_plots --results-dir ar_results/ \\
        --output ar_results.png [--per-iteration] [--scatter janssen extrapolation]

Reads the ``results_*.json`` files of ``cli/ar_benchmark.py`` and draws a
metric against the AR order for each method with bootstrap-t confidence
bands (``utils/stats.py``); ``--per-iteration`` adds Janssen's gap SDR by
iteration (``*.iters.png``), ``--scatter X Y`` one method's per-signal
values against another's (``*.scatter.png``).  :func:`method_series` is the
numbers of the main figure.

It runs on the host only and needs matplotlib (imported inside
:func:`main`), which the card's machine lacks.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["build_argparser", "load_results", "method_series", "main"]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Plot AR benchmark results")
    p.add_argument("--results-dir", default="./ar_results")
    p.add_argument("--metric", default="gap_sdr_db", choices=["gap_sdr_db", "fwseg_snr_db"])
    p.add_argument("--estimator", default=None, help="filter: lpc | arburg")
    p.add_argument("--output", default="ar_results.png")
    p.add_argument("--per-iteration", action="store_true",
                   help="also plot janssen SDR vs iteration for each order")
    p.add_argument("--scatter", nargs=2, metavar=("METHOD_X", "METHOD_Y"), default=None,
                   help="per-signal scatter of one method against another "
                        "(maintest_scatter.m's figure)")
    return p


def load_results(results_dir: Path) -> List[dict]:
    """The ``results_*.json`` entries under ``results_dir``, sorted by name."""
    results = [json.loads(f.read_text()) for f in sorted(results_dir.glob("results_*.json"))]
    if not results:
        raise SystemExit(f"no results_*.json under {results_dir}")
    return results


def _kept(results: List[dict], estimator: Optional[str]) -> List[dict]:
    return [e for e in results if not estimator or e["estimator"] == estimator]


def method_series(results: List[dict], metric: str, estimator: Optional[str] = None
                  ) -> Dict[str, Tuple[List[int], List[float], List[float], List[float]]]:
    """``{method: (orders, means, los, his)}`` of the main figure, methods
    sorted: each order's per-signal ``metric`` values and their
    bootstrap-t interval (``bootstrap_ci`` at its defaults)."""
    from ml_audio_inpainting_torch.utils.stats import bootstrap_ci

    by_method: Dict[str, Dict[int, np.ndarray]] = defaultdict(dict)
    for entry in _kept(results, estimator):
        for method, m in entry["methods"].items():
            by_method[method][entry["p"]] = np.asarray(m[metric])
    series = {}
    for method, by_order in sorted(by_method.items()):
        orders = sorted(by_order)
        means, los, his = [], [], []
        for p in orders:
            mean, lo, hi = bootstrap_ci(by_order[p][:, None])
            means.append(float(mean[0]))
            los.append(float(lo[0]))
            his.append(float(hi[0]))
        series[method] = (orders, means, los, his)
    return series


def main(argv=None) -> List[Path]:
    """Run the CLI; returns the figures written."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ml_audio_inpainting_torch.utils.stats import fill_interval

    args = build_argparser().parse_args(argv)
    results = load_results(Path(args.results_dir))
    kept = _kept(results, args.estimator)
    written = []

    fig, ax = plt.subplots(figsize=(8, 5))
    for method, (orders, means, los, his) in method_series(results, args.metric,
                                                            args.estimator).items():
        fill_interval(ax, orders, means, los, his, label=method)
    ax.set_xlabel("AR order p")
    ax.set_ylabel(args.metric)
    ax.set_xscale("log", base=2)
    ax.legend()
    ax.set_title(f"Classical inpainting: {args.metric} vs AR order")
    fig.tight_layout()
    fig.savefig(args.output, dpi=120)
    plt.close(fig)
    written.append(Path(args.output))
    print(f"wrote {args.output}")

    if args.scatter:
        mx, my = args.scatter
        fig, ax = plt.subplots(figsize=(6, 6))
        for entry in kept:
            if mx in entry["methods"] and my in entry["methods"]:
                ax.scatter(entry["methods"][mx][args.metric], entry["methods"][my][args.metric],
                           label=f"p={entry['p']} {entry['estimator']}", alpha=0.7)
        lims = ax.get_xlim() + ax.get_ylim()
        lo, hi = min(lims), max(lims)
        ax.plot([lo, hi], [lo, hi], "k--", linewidth=0.8)  # y = x
        ax.set_xlabel(f"{mx} {args.metric}")
        ax.set_ylabel(f"{my} {args.metric}")
        ax.legend()
        ax.set_title(f"Per-signal {args.metric}: {my} vs {mx}")
        out = Path(args.output).with_suffix(".scatter.png")
        fig.tight_layout()
        fig.savefig(out, dpi=120)
        plt.close(fig)
        written.append(out)
        print(f"wrote {out}")

    if args.per_iteration:
        fig, ax = plt.subplots(figsize=(8, 5))
        for entry in kept:
            per_iter = entry["methods"].get("janssen", {}).get("gap_sdr_per_iter_db")
            if per_iter:
                arr = np.asarray(per_iter)  # (signals, iterations)
                ax.plot(1 + np.arange(arr.shape[1]), arr.mean(axis=0),
                        label=f"p={entry['p']} {entry['estimator']}")
        ax.set_xlabel("Janssen iteration")
        ax.set_ylabel("gap SDR (dB)")
        ax.legend()
        out = Path(args.output).with_suffix(".iters.png")
        fig.tight_layout()
        fig.savefig(out, dpi=120)
        plt.close(fig)
        written.append(out)
        print(f"wrote {out}")
    return written


if __name__ == "__main__":
    main()

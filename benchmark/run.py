"""The benchmark of ``ml_audio_inpainting_torch`` on one CUDA card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Loads the cell named in ``BENCHMARK.json``
(``spec.py`` says which files make it), builds the program's entry point
with seeded weights, warms up the cell's shapes, measures for ``--seconds``,
and compares what the window produced with the plain reference.  Prints
one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s`` of the traced stretch), with ``--trace 1`` a ``breakdown``, and
last ``checks``: each number compared beside its limit, which are also the
last lines on standard error.

Exits 2 without a result when there is no CUDA card or fewer than the cell
asks for, and 3 when a module of JAX or of the JAX package is loaded once
the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from benchmark import measure, spec

# Top-level names of modules that the process printing a result may not hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_audio_inpainting_tpu")
# Cache directories of the libraries the program may use, inside the checkout.
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit():
    """The card's power limit in W as ``nvidia-smi`` reads it (None where it
    cannot): a share of a peak is stated beside it."""
    try:
        return float(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=power.limit",
                                     "--format=csv,noheader,nounits"], capture_output=True,
                                    text=True, timeout=60, check=True).stdout.strip())
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def result_line(cell, outcome: measure.Outcome, trace: bool, device: dict) -> dict:
    if trace:
        metrics = {}
        for name, reader in spec.readers(cell).items():
            value = reader.read(outcome.context)
            if value is not None:
                unit = next(m["unit"] for m in cell.per_layer if m["name"] == name)
                metrics[name] = {"value": value, "unit": unit}
    else:
        metrics = {m["name"]: {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    traced = outcome.context.get("trace")
    if trace and traced:
        device["busy_s"] = traced["busy_s"]
        device["window_s"] = traced["window_s"]
        line["breakdown"] = {"device_ops": traced["device_ops"],
                             "idle_gaps": traced["idle_gaps"]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = spec.load_cell(args.workload)
    for var, sub in CACHES.items():
        os.environ[var] = str(spec.HERE / "_cache" / sub)
    os.environ["USE_FLAX"] = "0"

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    watts = power_limit()
    print(f"benchmark: {cell.name} seed {args.seed} on {torch.cuda.get_device_name(0)}, "
          f"power limit {watts} W", file=sys.stderr)

    outcome = spec.loop(cell).run(cell, spec.family(cell), args.seed, args.seconds,
                                    bool(args.trace), "cuda")

    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found}: the port must not load them",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": outcome.memory_peak_bytes,
              "power_limit_w": watts}
    line = result_line(cell, outcome, bool(args.trace), device)
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

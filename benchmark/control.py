"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size: for each seed, each number compared of the program (the
lower reading), of the cell's lower-precision control put in the program's
place (the upper reading), and of the planted faults the cell can have.
The benchmark's own runs do not run this.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 [--faults ...]

Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import spec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--faults", nargs="*", default=[])
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(args.workload)
    loop, family = spec.loop(cell), spec.family(cell)
    for seed in args.seeds:
        out = loop.readings(cell, family, seed, "cuda", tuple(args.faults))
        print(json.dumps({"workload": cell.name, "seed": seed, **out}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

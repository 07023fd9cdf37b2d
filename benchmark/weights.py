"""Seeded weights, made on the device in a few large draws.

A configuration's reference lists its tensors by kind (``param_shapes``).
Kernels of convolutions and dense layers take flax's default,
``lecun_normal`` (a normal truncated to two standard deviations, variance
1 / fan_in), all from one draw; the BiLSTM's matrices are drawn uniform on
(-1/sqrt(rows), 1/sqrt(rows)), all from one draw, which keeps its gates
off saturation (the published init, U[0, 2/sqrt(H)), saturates every gate
at these widths, and then neither the recurrence nor its gradient depends
on the input); biases 0; BatchNorm's scale and running variance 1, its
shift and running mean 0.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

TRUNC_STD = 0.87962566103423978  # std of N(0, 1) truncated to [-2, 2]


def materialize(shapes: Dict[str, tuple], gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` on ``device`` of ``shapes`` (``{name: (kind,
    shape)}``) from ``gen``, a generator on that device."""
    out: Dict[str, torch.Tensor] = {}
    normal = [k for k, (kind, _) in shapes.items() if kind in ("conv", "dense")]
    uniform = [k for k, (kind, _) in shapes.items() if kind in ("lstm_ih", "lstm_hh")]
    for names, fill in ((normal, "normal"), (uniform, "uniform")):
        total = sum(math.prod(shapes[k][1]) for k in names)
        if not total:
            continue
        flat = torch.empty(total, device=device)
        if fill == "normal":
            torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
        else:
            flat.uniform_(-1.0, 1.0, generator=gen)
        offset = 0
        for k in names:
            shape = shapes[k][1]
            n = math.prod(shape)
            if fill == "normal":
                scale = math.sqrt(1.0 / math.prod(shape[1:])) / TRUNC_STD
            else:
                scale = 1.0 / math.sqrt(shape[0])
            out[k] = flat[offset:offset + n].view(shape) * scale
            offset += n
    for k, (kind, shape) in shapes.items():
        if kind == "zero":
            out[k] = torch.zeros(shape, device=device)
        elif kind == "one":
            out[k] = torch.ones(shape, device=device)
        elif kind == "count":
            out[k] = torch.zeros(shape, dtype=torch.int64, device=device)
    return {k: out[k] for k in shapes}


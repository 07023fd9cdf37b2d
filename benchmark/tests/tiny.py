"""Cells of the benchmark at a size a CPU test holds: the committed cell's
files with the widths, clip length and counts cut, on the CPU."""

from __future__ import annotations

import copy

from benchmark import spec

TINY_GAN = {"enc_layer_cfg": [[8, 7, 2], [16, 5, 2], [16, 3, 2]],
            "dec_layer_cfg": [[16, 3, 1], [8, 3, 1]], "final_interim_ch": 8}
TINY_CNN = {"lstm_hidden_dim": 8, "num_lstm_layers": 2, "enc_filters": [4, 4],
            "dec_filters": [4, 4]}


def tiny_cell(name: str, dtype: str = None, bench=None, root=spec.ROOT, base=spec.HERE,
              **mix) -> spec.Cell:
    """The committed cell ``name`` with 1 s clips, the generator cut to
    :data:`TINY_GAN`, the CNN to :data:`TINY_CNN`, training batches of 2,
    small counts (``mix`` overrides the mix's numbers), and in ``dtype``
    when given."""
    cell = spec.load_cell(name, bench, root, base)
    cell.config = copy.deepcopy(cell.config)
    cell.config["data"]["max_len_s"] = 1.0
    model = cell.config["model"]
    if "generator" in model:
        model["generator"].update(TINY_GAN)
    if "lstm_hidden_dim" in model:
        model.update(TINY_CNN)
    cell.mix = {**cell.mix, "batch": 2, "pool_requests": 6, "warmup_requests": 1,
                "trace_requests": 2, "check_requests": 3, "clip_seconds": 1.0,
                "corpus_clips": 8, "gap_layouts": 4, "setup_steps": 4, "trace_steps": 1, **mix}
    cell.settings = copy.deepcopy(cell.settings)
    if "recipe" in cell.settings:
        cell.settings["recipe"]["training"]["batch_size"] = 2
    if dtype:
        cell.settings["dtype"] = dtype
    return cell

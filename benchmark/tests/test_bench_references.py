"""Each plain reference against the program, at a tiny size on the CPU and
in f32, through the loops' own readings: the same seeded weights and
inputs give the same patches (to a PCM16 step) and the same training
steps."""

import pytest
import torch

from benchmark import spec
from benchmark.tests.tiny import tiny_cell


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", ["gan_serve_bf16_b32", "cnn_blstm_serve_f32_b32"])
def test_serving_reference_matches_the_program(name):
    cell = tiny_cell(name, "float32")
    out = spec.loop(cell).readings(cell, spec.family(cell), 11, "cpu")
    assert out["program"]["patch_gap_lsb"] <= 1
    assert out["program"]["patch_flip_share"] < 1.0
    assert out["program"]["start_mismatch"] == 0


def test_training_reference_matches_the_program():
    cell = tiny_cell("cnn_blstm_train_bf16_b128", "float32")
    out = spec.loop(cell).readings(cell, spec.family(cell), 12, "cpu")["program"]
    assert out["feed_mismatch"] == 0
    assert out["loss_gap"] < 1e-4
    assert out["grad_gap"] < 1e-3
    assert out["grad_diff_leaf"] < 1e-3
    assert out["update_gap"] < 1e-2
    assert out["update_diff"] < 1e-2

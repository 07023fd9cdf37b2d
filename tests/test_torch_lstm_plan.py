"""The launch plans of the backward LSTM kernels (``csrc/lstm_bwd.cu``), as
``ops/cuda/lstm_cell.py`` computes them for the launchers.  The kernels run
only on the card; what decides which thread computes what is checked here:

* ``bwd_plan`` (the sweep): the CTAs of a cluster own every hidden unit and
  every gate column exactly once, the k-slices of the gate recomputation
  cover every input exactly once, and each phase fits the CTA's threads;
* ``dwhh_plan`` (the split-K reduction): the slices cover every row of
  K = B*T exactly once, none is empty, and the tiles cover dW_hh;
* the constants the plans use are the ones the CUDA source declares, and
  the text edits of ``scripts/torch_lstm_bwd_phases.py`` still find the
  phases of the sweep they switch off.
"""

import re

import pytest

from ml_audio_inpainting_torch.ops.cuda import lstm_cell
from ml_audio_inpainting_torch.ops.cuda.lstm_cell import (
    BWD_ROWS,
    BWD_THREADS,
    DWHH_DEPTH,
    DWHH_TILE,
    bwd_plan,
    dwhh_plan,
)
from scripts.torch_lstm_bwd_phases import VARIANTS, variant_sources

HIDDEN = list(range(4, lstm_cell.MAX_HIDDEN + 1, 4))


@pytest.mark.parametrize("H", HIDDEN)
def test_bwd_plan_covers_every_unit_and_column_once(H):
    plan = bwd_plan(25, H)
    assert plan.cluster in (4, 8) and H % plan.cluster == 0
    assert plan.units * plan.cluster == H
    units = [n for r in range(plan.cluster) for n in plan.units_of(r)]
    assert sorted(units) == list(range(H))
    cols = [j for r in range(plan.cluster) for j in plan.columns_of(r)]
    assert sorted(cols) == list(range(4 * H))
    # Column lc of CTA r is gate lc // units of unit r * units + lc % units.
    for r in range(plan.cluster):
        for lc, j in enumerate(plan.columns_of(r)):
            assert j == (lc // plan.units) * H + r * plan.units + lc % plan.units


@pytest.mark.parametrize("H", HIDDEN)
def test_bwd_plan_k_slices_cover_every_input_once(H):
    plan = bwd_plan(25, H)
    parts = plan.k_parts()
    assert len(parts) == plan.ksplit
    assert parts[0][0] == 0 and parts[-1][1] == H
    for (b0, e0), (b1, _) in zip(parts, parts[1:]):
        assert e0 == b1
    for b, e in parts:
        assert b < e and b % 4 == 0 and e % 4 == 0  # float4 reads of h_prev


@pytest.mark.parametrize("H", HIDDEN)
def test_bwd_plan_phases_fit_the_threads(H):
    plan = bwd_plan(25, H)
    assert 4 * plan.units * plan.ksplit <= BWD_THREADS  # B: (column, k-slice) a thread
    assert (BWD_ROWS // 2) * H <= BWD_THREADS  # A: (unit, row pair) a thread
    assert BWD_ROWS * plan.units <= BWD_THREADS  # C: (row, own unit) a thread


@pytest.mark.parametrize("B", [1, 3, 4, 5, 25, 128])
def test_bwd_plan_covers_every_batch_row_once(B):
    plan = bwd_plan(B, 128)
    rows = [g * BWD_ROWS + r for g in range(plan.groups) for r in range(BWD_ROWS)
            if g * BWD_ROWS + r < B]
    assert rows == list(range(B))
    assert plan.groups == -(-B // BWD_ROWS)
    assert plan.grid == (plan.cluster * plan.groups, 2)


def test_bwd_plan_at_the_training_shapes():
    """B=25: 7 clusters of 8 CTAs a direction, 112 CTAs, one wave of an
    H100's 132 SMs; each CTA owns 16 units, 64 columns, 4 k-slices of 32."""
    plan = bwd_plan(25, 128)
    assert (plan.cluster, plan.units, plan.ksplit, plan.groups) == (8, 16, 4, 7)
    assert plan.grid[0] * plan.grid[1] == 112


@pytest.mark.parametrize("B,T,H", [
    (25, 417, 128), (128, 417, 128), (1, 1, 4), (1, 1, 128), (5, 29, 16), (3, 11, 4),
    (7, 23, 12), (6, 1, 128), (1, 33, 128), (2, 100, 100),
])
def test_dwhh_plan_covers_every_row_of_k_once(B, T, H):
    plan = dwhh_plan(B, T, H)
    assert plan.K == B * T
    assert plan.rows_per_slice % DWHH_DEPTH == 0
    assert plan.rows_per_slice <= lstm_cell.DWHH_MAX_SLICE_ROWS
    rows = [m for s in range(plan.slices) for m in plan.rows_of(s)]
    assert rows == list(range(B * T))
    assert all(len(plan.rows_of(s)) > 0 for s in range(plan.slices))
    assert plan.tiles_i * DWHH_TILE >= H > (plan.tiles_i - 1) * DWHH_TILE
    assert plan.tiles_j * DWHH_TILE >= 4 * H > (plan.tiles_j - 1) * DWHH_TILE
    assert plan.grid == (plan.tiles_i * plan.tiles_j, plan.slices, 2)
    assert plan.partial_shape == (2, plan.slices, H, 4 * H)


def test_dwhh_plan_at_the_training_shapes():
    """K = 25 * 417 = 10 425 in 8 slices of 1312 rows; 2 x 8 tiles of 64 x
    64 a direction: 256 blocks, about two on each of 132 SMs."""
    plan = dwhh_plan(25, 417, 128)
    assert (plan.slices, plan.rows_per_slice, plan.tiles_i, plan.tiles_j) == (8, 1312, 2, 8)
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] == lstm_cell.DWHH_TARGET_BLOCKS


def test_dwhh_plan_at_the_largest_committed_batch():
    """B=128 (cnn_blstm_formant_v2_b128_r4.npz): K = 53 376 in 40 slices of
    1344 rows, 1280 blocks."""
    plan = dwhh_plan(128, 417, 128)
    assert (plan.slices, plan.rows_per_slice) == (40, 1344)
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] == 1280


def test_plan_constants_match_the_cuda_source():
    src = lstm_cell.SOURCES["lstm_bwd"].read_text()
    declared = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(declared["kRows"]) == BWD_ROWS
    assert int(declared["kThreads"]) == BWD_THREADS
    assert int(declared["kTile"]) == DWHH_TILE
    assert int(declared["kDepth"]) == DWHH_DEPTH
    assert int(declared["kMaxCluster"]) == 8
    # The k-slice span the kernel derives from ksplit, as BwdPlan.k_parts does.
    assert "const int kspan = ((H + ksplit - 1) / ksplit + 3) / 4 * 4;" in src


def test_phase_variants_find_their_edits_in_the_kernel():
    sources = variant_sources()
    assert sources["all"] == lstm_cell.SOURCES["lstm_bwd"].read_text()
    assert len(set(sources.values())) == len(VARIANTS)  # every edit changed something

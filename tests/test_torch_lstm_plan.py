"""The launch plans of the LSTM kernels (``csrc/lstm_fwd.cu``,
``csrc/lstm_bwd.cu``), as ``ops/cuda/lstm_cell.py`` computes them for the
launchers.  The kernels run only on the card; what decides which thread
computes what is checked here:

* ``fwd_plan`` (the forward sweep), for every H the kernels take and several
  batches: the lanes of a cluster (CTA rank, unit, gate, k-slice, in the
  kernel's own mapping) own every hidden unit's 4 gate columns and every
  k-input exactly once, the clusters every batch row, and a CTA fits its
  threads and the 227 KB of shared memory;
* ``bwd_plan`` (the backward sweep): the CTAs of a cluster own every hidden unit and
  every gate column exactly once, the k-slices of the gate recomputation
  cover every input exactly once, and each phase fits the CTA's threads;
* ``dwhh_plan`` (the split-K reduction): the slices cover every row of
  K = B*T exactly once, none is empty, and the tiles cover dW_hh;
* the constants the plans use are the ones the CUDA sources declare, and
  the text edits of ``scripts/torch_lstm_bwd_phases.py`` and
  ``scripts/torch_lstm_fwd_phases.py`` still find the phases of the sweeps
  they switch off.
"""

import re

import pytest
import torch

from ml_audio_inpainting_torch.ops.cuda import lstm_cell
from ml_audio_inpainting_torch.ops.cuda.lstm_cell import (
    BWD_ROWS,
    BWD_THREADS,
    DWHH_DEPTH,
    DWHH_TILE,
    FWD_MAX_CLUSTER,
    FWD_MAX_HIDDEN,
    FWD_ROW_CHOICES,
    FWD_STAGES,
    FWD_THREADS,
    bwd_plan,
    dwhh_plan,
    fwd_plan,
    fwd_smem_bytes,
)
from scripts import torch_lstm_fwd_phases
from scripts.torch_lstm_bwd_phases import VARIANTS, variant_sources
from torch_threads import one_thread  # noqa: F401  (a module fixture)

HIDDEN = list(range(4, lstm_cell.MAX_HIDDEN + 1, 4))
BATCHES = [1, 5, 25, 32, 128]
SMEM_PER_BLOCK = 232_448  # bytes of shared memory an H100 CTA may use (227 KB)


def _fwd_lanes(plan):
    """(tid, unit m, gate q, k-slice kq) of every thread of an lstm_fwd CTA,
    in the kernel's mapping (kq = tid % KQ, q = (tid / KQ) % 4,
    m = tid / (4 KQ)); only lanes with m < units own a column."""
    KQ = plan.ksplit
    return [(tid, tid // (4 * KQ), (tid // KQ) % 4, tid % KQ) for tid in range(FWD_THREADS)]


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("H", HIDDEN)
def test_fwd_plan_covers_every_unit_and_gate_column_once(H, B):
    plan = fwd_plan(B, H)
    assert plan.cluster in (4, 8) and plan.cluster <= FWD_MAX_CLUSTER
    assert plan.cluster == (8 if H % 8 == 0 else 4)  # 4 CTAs where 8 does not divide H
    assert plan.units * plan.cluster == H
    owned = []  # (global gate column, k-slice) of every owning lane of the cluster
    for rank in range(plan.cluster):
        n0 = rank * plan.units
        for _, m, q, kq in _fwd_lanes(plan):
            if m < plan.units:
                owned.append((q * H + n0 + m, kq))
    assert sorted(owned) == sorted((j, kq) for j in range(4 * H) for kq in range(plan.ksplit))
    # The columns of CTA r are the 4 gates of its units, in its slice's order.
    for r in range(plan.cluster):
        assert sorted(plan.columns_of(r)) == sorted(
            q * H + n for q in range(4) for n in plan.units_of(r))


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("H", HIDDEN)
def test_fwd_plan_k_slices_cover_every_input_once(H, B):
    plan = fwd_plan(B, H)
    assert plan.ksplit in (2, 4)
    parts = plan.k_parts()
    assert len(parts) == plan.ksplit
    covered = [k for b, e in parts for k in range(b, e)]
    assert covered == list(range(H))
    span = parts[0][1] - parts[0][0]
    assert span % 4 == 0  # float4 reads of h
    assert span <= FWD_MAX_HIDDEN // plan.ksplit  # a slice's W_hh fits the lane's registers
    # Unit n sits in slice n // span at offset n % span of an h row, and the
    # slices' segments are disjoint: every unit has its own place.
    seg = FWD_MAX_HIDDEN // plan.ksplit + 4
    places = [(n // span) * seg + n % span for n in range(H)]
    assert len(set(places)) == H and all(p % seg < span for p in places)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("H", HIDDEN)
def test_fwd_plan_covers_every_batch_row_once(H, B):
    plan = fwd_plan(B, H)
    assert plan.rows in FWD_ROW_CHOICES
    rows = [b for g in range(plan.groups) for b in plan.batch_rows_of(g)]
    assert rows == list(range(B))
    assert all(len(plan.batch_rows_of(g)) > 0 for g in range(plan.groups))
    assert plan.grid == (plan.cluster * plan.groups, 2)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("H", HIDDEN)
def test_fwd_plan_fits_the_threads_and_shared_memory(H, B):
    plan = fwd_plan(B, H)
    assert 4 * plan.ksplit * plan.units <= FWD_THREADS  # a lane per (unit, gate, k-slice)
    assert FWD_THREADS % (4 * plan.ksplit) == 0 and 32 % (4 * plan.ksplit) == 0  # a unit's lanes in one warp
    assert fwd_smem_bytes(plan) <= SMEM_PER_BLOCK
    for rows in FWD_ROW_CHOICES:
        assert fwd_smem_bytes(fwd_plan(B, H, rows)) <= SMEM_PER_BLOCK


def test_fwd_plan_at_the_main_paths_shapes():
    """Serving (B=32) and training (B=25): 2 rows a cluster, 16 and 13
    clusters of 8 CTAs a direction, each CTA 16 units x 4 gates x 4
    k-slices of 32 on its 256 lanes; B=128: 8 rows, 16 clusters."""
    for B, rows, groups in ((32, 2, 16), (25, 2, 13), (128, 8, 16)):
        plan = fwd_plan(B, 128)
        assert (plan.rows, plan.cluster, plan.units, plan.ksplit, plan.groups) == (
            rows, 8, 16, 4, groups)
        assert 4 * plan.ksplit * plan.units == FWD_THREADS
    assert fwd_plan(32, 128).grid[0] * 2 == lstm_cell.FWD_TARGET_CTAS


def test_fwd_plan_refuses_rows_the_kernel_has_not():
    with pytest.raises(ValueError, match="batch rows a cluster"):
        fwd_plan(32, 128, rows=3)


def test_fwd_plan_constants_match_the_cuda_source():
    src = lstm_cell.SOURCES["lstm_fwd"].read_text()
    declared = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(declared["kThreads"]) == FWD_THREADS
    assert int(declared["kMaxCluster"]) == FWD_MAX_CLUSTER
    assert int(declared["kStages"]) == FWD_STAGES
    assert int(declared["kMaxHidden"]) == FWD_MAX_HIDDEN == lstm_cell.MAX_HIDDEN
    assert {int(r) for r in re.findall(r"launch_plan<Elem, (\d+), KQ>", src)} == set(
        FWD_ROW_CHOICES)
    assert set(re.findall(r"launch_rows<Elem, (\d+)>", src)) == {"2", "4"}
    # The element types' codes at the C interface.
    assert {torch.float32: int(declared["kF32"]), torch.bfloat16: int(declared["kBF16"])} == (
        lstm_cell.DTYPE_CODES)
    assert set(re.findall(r"launch_elem<([\w]+)>", src)) == {"float", "__nv_bfloat16"}
    # The lane mapping and the h layout that the tests above mirror.
    for line in ("const int kq = tid % KQ;", "const int q = (tid / KQ) % 4;",
                 "const int m = tid / kLanes;", "kspan = ((H + ksplit - 1) / ksplit + 3) / 4 * 4;",
                 "hseg = kMaxHidden / ksplit + 4;",
                 "const int h_at = (n / kspan) * lay.hseg + n % kspan;"):
        assert line in src, line


def test_fwd_phase_variants_find_their_edits_in_the_kernel():
    sources = torch_lstm_fwd_phases.variant_sources()
    assert sources["all"] == lstm_cell.SOURCES["lstm_fwd"].read_text()
    assert len(set(sources.values())) == len(torch_lstm_fwd_phases.VARIANTS)


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
    assert {torch.float32: int(declared["kF32"]), torch.bfloat16: int(declared["kBF16"])} == (
        lstm_cell.DTYPE_CODES)
    assert set(re.findall(r"launch_(?:bwd|dwhh)<([\w]+)>", src)) == {"float", "__nv_bfloat16"}
    # The k-slice span the kernel derives from ksplit, as BwdPlan.k_parts does.
    assert "const int kspan = ((H + ksplit - 1) / ksplit + 3) / 4 * 4;" in src


def test_phase_variants_find_their_edits_in_the_kernel():
    sources = variant_sources()
    assert sources["all"] == lstm_cell.SOURCES["lstm_bwd"].read_text()
    assert len(set(sources.values())) == len(VARIANTS)  # every edit changed something

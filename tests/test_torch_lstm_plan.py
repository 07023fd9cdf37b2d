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
* ``bwd_mma_plan`` and ``dwhh_mma_plan`` (the bf16 forms on the tensor
  cores): the clusters cover every batch row once, the warps' fragment
  tiles every (gate column, input) and (unit, gate column) pair of a CTA
  once, phase C's items every (row, unit) once; a CTA fits its warps, the
  kernel's instances, the registers and the shared memory, and the
  production batch fills one wave of an H100's SMs;
* ``fwd_mma_plan`` (the bf16 forward on the tensor cores): the clusters
  cover every batch row once, the unit groups of the cluster fill every
  B-fragment slot of the gate product once, a CTA fits its warps and the
  shared memory; and the kernel's fragments, written out again here from
  its source (the A fragments of W_hh over the padded inputs, the h pieces
  transposed into the slots, the accumulators read as four gates of a unit
  for two rows), give ``h @ W_hh`` for every H it takes;
* the constants the plans use are the ones the CUDA sources declare, and
  the text edits of ``scripts/torch_lstm_bwd_phases.py`` (both backward
  sweeps, f32 and bf16) and ``scripts/torch_lstm_fwd_phases.py`` still find
  the phases of the sweeps they switch off.
"""

import re

import numpy as np
import pytest
import torch

from ml_audio_inpainting_torch.ops.cuda import lstm_cell
from ml_audio_inpainting_torch.ops.cuda.lstm_cell import (
    BWD_MMA_MAX_UNITS,
    BWD_MMA_ROW_CHOICES,
    BWD_MMA_TARGET_CTAS,
    BWD_MMA_TILE_CHOICES,
    BWD_MMA_WARPS,
    BWD_ROWS,
    BWD_THREADS,
    DH_PIECES,
    DWHH_MMA_DEPTH,
    DWHH_MMA_STAGES,
    DWHH_MMA_TILE,
    DWHH_DEPTH,
    DWHH_TILE,
    FWD_MAX_CLUSTER,
    FWD_MAX_HIDDEN,
    FWD_MMA_MAX_TILES,
    FWD_MMA_PAIR_WARPS,
    FWD_MMA_ROWS,
    FWD_PIECES,
    FWD_ROW_CHOICES,
    FWD_SLOT_WORDS,
    FWD_STAGES,
    FWD_THREADS,
    bwd_mma_layout,
    bwd_mma_plan,
    bwd_plan,
    dwhh_mma_plan,
    dwhh_plan,
    fwd_mma_layout,
    fwd_mma_plan,
    fwd_plan,
    fwd_smem_bytes,
)
from scripts import torch_lstm_fwd_phases
from scripts.torch_lstm_bwd_phases import VARIANTS, VARIANTS_BF16, variant_sources
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
    assert {int(r) for r in re.findall(r"launch_plan<(\d+), KQ>", src)} == set(
        FWD_ROW_CHOICES)
    assert set(re.findall(r"launch_rows<(\d+)>", src)) == {"2", "4"}
    # Each element type has its own kernel: f32 lstm_fwd_kernel, bf16
    # lstm_fwd_mma_kernel, with their own launchers.
    assert lstm_cell.KERNEL_DTYPES == (torch.float32, torch.bfloat16)
    assert "lstm_fwd_kernel(const float* xw_fwd" in src
    assert "lstm_fwd_mma_kernel(const bf16* xw_fwd" in src
    assert "Elem" not in src
    # The lane mapping and the h layout that the tests above mirror.
    for line in ("const int kq = tid % KQ;", "const int q = (tid / KQ) % 4;",
                 "const int m = tid / kLanes;", "kspan = ((H + ksplit - 1) / ksplit + 3) / 4 * 4;",
                 "hseg = kMaxHidden / ksplit + 4;",
                 "const int h_at = (n / kspan) * lay.hseg + n % kspan;"):
        assert line in src, line


def test_fwd_phase_variants_find_their_edits_in_the_kernel():
    shipped = lstm_cell.SOURCES["lstm_fwd"].read_text()
    for form, variants in (("f32", torch_lstm_fwd_phases.VARIANTS),
                           ("bf16", torch_lstm_fwd_phases.VARIANTS_MMA)):
        sources = torch_lstm_fwd_phases.variant_sources(form)
        assert sources["all"] == shipped
        assert len(set(sources.values())) == len(variants)  # every edit changed something


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
    # The f32 kernels are instantiated for f32 alone; bf16 has kernels of its own.
    # The f32 sweep and partial sum are plain f32 kernels; the reduction is
    # instantiated for both forms' outputs.
    assert "auto kernel = lstm_bwd_kernel;" in src
    assert "lstm_dwhh_partial_kernel<<<" in src
    assert set(re.findall(r"lstm_dwhh_reduce_kernel<([\w]+)><<<", src)) == {"float", "bf16"}
    # The k-slice span the kernel derives from ksplit, as BwdPlan.k_parts does.
    assert "const int kspan = ((H + ksplit - 1) / ksplit + 3) / 4 * 4;" in src
    # The bf16 forms: their constants, instances, strides and warp mappings,
    # which bwd_mma_plan, bwd_mma_layout and the tests above mirror.
    assert int(declared["kPieces"]) == DH_PIECES
    assert int(declared["kMaxUnits"]) == BWD_MMA_MAX_UNITS
    assert int(declared["kThreads"]) // 32 == BWD_MMA_WARPS
    assert int(declared["kDwTile"]) == DWHH_MMA_TILE
    assert int(declared["kDwDepth"]) == DWHH_MMA_DEPTH
    assert int(declared["kDwStages"]) == DWHH_MMA_STAGES
    assert set(re.findall(r"lstm_bwd_mma_kernel<(\d+), (\d+)>;", src)) == {
        (str(r), str(t)) for r in BWD_MMA_ROW_CHOICES for t in BWD_MMA_TILE_CHOICES}
    assert set(re.findall(r"lstm_dwhh_mma_kernel<(\d+)>;", src)) == {"4", "8"}
    for line in ("ldh = 16 * kh + 8;", "ldd = 16 * kc + 8;", "ldp = 16 * kh + 4;",
                 "ldg = 16 * kc + 4;", "span = (kh + ksplit - 1) / ksplit;",
                 "const int gq = warp / kc, gm = warp - gq * kc;",
                 "const bool d_warp = warp < kh;",
                 "constexpr int kCPer = (Rows * 4 * Tiles + kThreads - 1) / kThreads;",
                 "cr[j] = e / units;", "const int wm = warp / 4, wn = warp % 4;"):
        assert line in src, line


def test_phase_variants_find_their_edits_in_the_kernel():
    for form, variants in (("f32", VARIANTS), ("bf16", VARIANTS_BF16)):
        sources = variant_sources(form)
        assert sources["all"] == lstm_cell.SOURCES["lstm_bwd"].read_text()
        assert len(set(sources.values())) == len(variants)  # every edit changed something


def _mma_warps(plan):
    """(warp, gate column tile, k-tiles) of the gate product and (warp, unit
    tile, column tiles) of the dh product, in the kernel's mapping."""
    lay = bwd_mma_layout(plan)
    gate, dh = [], []
    for w in range(BWD_MMA_WARPS):
        gq, gm = divmod(w, lay.kc)
        if gq < plan.ksplit:
            gate.append((w, gm, [gq * lay.span + i for i in range(lay.span)
                                 if gq * lay.span + i < lay.kh]))
        if w < lay.kh:
            dh.append((w, w, list(range(lay.kc))))
    return gate, dh


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("H", HIDDEN)
def test_bwd_mma_plan_covers_every_row_unit_and_column_once(H, B):
    plan = bwd_mma_plan(B, H)
    lay = bwd_mma_layout(plan)
    assert plan.rows in BWD_MMA_ROW_CHOICES
    assert plan.cluster == (8 if H % 8 == 0 else 4) and plan.units * plan.cluster == H
    assert [b for g in range(plan.groups) for b in plan.batch_rows_of(g)] == list(range(B))
    assert plan.grid == (plan.cluster * plan.groups, 2)
    # Fragment tiles: 16 columns (or inputs, or units) each; the padding
    # past 4u columns and H inputs or units is W_hh's zero.
    assert (lay.kc - 1) * 16 < 4 * plan.units <= lay.kc * 16
    assert (lay.kh - 1) * 16 < H <= lay.kh * 16
    gate, dh = _mma_warps(plan)
    assert sorted((m, k) for _, m, ks in gate for k in ks) == [
        (m, k) for m in range(lay.kc) for k in range(lay.kh)]
    assert sorted((m, k) for _, m, ks in dh for k in ks) == [
        (m, k) for m in range(lay.kh) for k in range(lay.kc)]
    assert all(ks for _, _, ks in gate)  # no empty k-slice
    # Phase C: kCPer (batch row, own unit) items a thread, each once; the
    # instance's Tiles bounds the units (4u <= 16 kc <= 16 Tiles).
    tiles = next(t for t in BWD_MMA_TILE_CHOICES if lay.tiles <= t)
    assert plan.units <= 4 * tiles
    per = -(-plan.rows * 4 * tiles // BWD_THREADS)
    items = [divmod(t + j * BWD_THREADS, plan.units) for t in range(BWD_THREADS)
             for j in range(per) if t + j * BWD_THREADS < plan.rows * plan.units]
    assert sorted(items) == [(r, m) for r in range(plan.rows) for m in range(plan.units)]


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("H", HIDDEN)
def test_bwd_mma_plan_fits_the_warps_registers_and_shared_memory(H, B):
    plan = bwd_mma_plan(B, H)
    lay = bwd_mma_layout(plan)
    assert plan.units <= BWD_MMA_MAX_UNITS
    assert lay.kc * plan.ksplit <= BWD_MMA_WARPS and lay.kh <= BWD_MMA_WARPS
    # The instance (Tiles) that takes the plan, and its A fragments: two
    # products x Tiles x 4 registers a lane.
    tiles = next(t for t in BWD_MMA_TILE_CHOICES if lay.tiles <= t)
    assert lay.span <= tiles and lay.kc <= tiles
    assert 2 * tiles * 4 <= 64
    assert lay.smem_bytes <= SMEM_PER_BLOCK
    if H % 8 == 0:
        assert tiles == BWD_MMA_TILE_CHOICES[0]  # every cluster of 8 takes the smaller instance


def test_bwd_mma_plan_at_the_production_batch():
    """B=128, H=128: 16 rows a cluster, 8 clusters of 8 CTAs a direction,
    128 CTAs, one wave at one CTA an SM; each CTA 16 units, 64 columns (4
    tiles), the gate product's 8 k-tiles in 2 slices of 4 (32 A-fragment
    registers a lane for both products); B=25: 8 rows, 64 CTAs."""
    plan = bwd_mma_plan(128, 128)
    lay = bwd_mma_layout(plan)
    assert (plan.rows, plan.cluster, plan.units, plan.ksplit, plan.groups) == (16, 8, 16, 2, 8)
    assert (lay.kh, lay.kc, lay.span, lay.tiles) == (8, 4, 4, 4)
    assert plan.grid[0] * plan.grid[1] == 128 <= BWD_MMA_TARGET_CTAS
    small = bwd_mma_plan(25, 128)
    assert (small.rows, small.groups, small.grid[0] * small.grid[1]) == (8, 4, 64)


@pytest.mark.parametrize("H", [4, 12, 64, 128])
def test_bwd_mma_plan_picks_the_rows_from_the_batch(H):
    """The fewest rows a cluster that keep both directions' grid within one
    wave of one CTA an SM, else the most."""
    for B in range(1, 300):
        plan = bwd_mma_plan(B, H)
        if plan.grid[0] * plan.grid[1] > BWD_MMA_TARGET_CTAS:
            assert plan.rows == BWD_MMA_ROW_CHOICES[-1]
        assert all(2 * plan.cluster * -(-B // r) > BWD_MMA_TARGET_CTAS
                   for r in BWD_MMA_ROW_CHOICES if r < plan.rows)


@pytest.mark.parametrize("B,T,H", [
    (25, 417, 128), (128, 417, 128), (1, 1, 4), (1, 1, 128), (5, 29, 16), (3, 11, 4),
    (7, 23, 12), (6, 1, 128), (1, 33, 128), (2, 100, 100),
])
def test_dwhh_mma_plan_covers_every_row_of_k_once(B, T, H):
    plan = dwhh_mma_plan(B, T, H)
    assert plan.K == B * T and plan.rows_per_slice % DWHH_MMA_DEPTH == 0
    rows = [m for s in range(plan.slices) for m in plan.rows_of(s)]
    assert rows == list(range(B * T))
    assert all(len(plan.rows_of(s)) > 0 for s in range(plan.slices))
    assert plan.tiles_i == 1 and H <= DWHH_MMA_TILE  # a tile holds every unit
    assert plan.tiles_j * DWHH_MMA_TILE >= 4 * H > (plan.tiles_j - 1) * DWHH_MMA_TILE
    assert plan.partial_shape == (2, plan.slices, H, 4 * H)


def test_dwhh_mma_plan_at_the_production_batch():
    """B=128: K = 53 376 in 33 slices of 1632 rows; 4 column tiles a
    direction, 264 blocks, two on each of 132 SMs (2 x 78 KB of shared
    memory)."""
    plan = dwhh_mma_plan(128, 417, 128)
    assert (plan.slices, plan.rows_per_slice, plan.tiles_j) == (33, 1632, 4)
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] == 264
    assert 2 * (2 * DWHH_MMA_STAGES * 3 * DWHH_MMA_DEPTH * (DWHH_MMA_TILE + 8)) <= 232_448


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("H", HIDDEN)
def test_fwd_mma_plan_covers_every_row_and_slot_once(H, B):
    plan = fwd_mma_plan(B, H)
    lay = fwd_mma_layout(plan)
    assert plan.rows == FWD_MMA_ROWS and plan.ksplit == FWD_MMA_PAIR_WARPS
    assert plan.cluster == (8 if H % 8 == 0 else 4) and plan.units * plan.cluster == H
    assert [b for g in range(plan.groups) for b in plan.batch_rows_of(g)] == list(range(B))
    assert plan.grid == (plan.cluster * plan.groups, 2)
    # The units padded to groups of 8; the cluster's padded units are whole
    # k-tiles of the gate product, and each (k-tile, half) slot is filled by
    # one unit group of one CTA.
    assert lay.upad % 8 == 0 and plan.units <= lay.upad < plan.units + 8
    assert lay.ktiles * 16 == plan.cluster * lay.upad
    slots = sorted(lay.slot_of(r, j) for r in range(plan.cluster) for j in range(lay.ugroups))
    assert slots == list(range(2 * lay.ktiles))


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("H", HIDDEN)
def test_fwd_mma_plan_fits_the_warps_and_shared_memory(H, B):
    plan = fwd_mma_plan(B, H)
    lay = fwd_mma_layout(plan)
    # A warp keeps 2 x ktiles / 2 x 4 registers of A fragments.
    assert lay.ktiles <= FWD_MMA_MAX_TILES and lay.ktiles % FWD_MMA_PAIR_WARPS == 0
    assert lay.threads == 32 * lay.ugroups * plan.rows // 8 * FWD_MMA_PAIR_WARPS
    assert lay.threads <= FWD_MMA_PAIR_WARPS * FWD_THREADS
    assert lay.ugroups * plan.rows // 8 <= 15  # a named barrier (1 .. 15) a tile pair
    assert lay.smem_bytes <= SMEM_PER_BLOCK and lay.smem_bytes % 16 == 0
    assert lay.step_bytes < 2 ** 20  # an mbarrier's transaction count


def test_fwd_mma_plan_at_the_production_batch():
    """B=128, H=128: 8 rows a cluster, 16 clusters of 8 CTAs a direction,
    256 CTAs, two on each SM; each CTA 16 units in 2 groups x 1 n-tile = 2
    tile pairs of 2 warps (4 warps), the gate product's 8 k-tiles, 4 a warp,
    8 KB of slots received a step; B=25 and B=32: 8 rows, 64 CTAs; B=256:
    8 rows, 512 CTAs."""
    plan = fwd_mma_plan(128, 128)
    lay = fwd_mma_layout(plan)
    assert (plan.rows, plan.cluster, plan.units, plan.ksplit, plan.groups) == (8, 8, 16, 2, 16)
    assert (lay.upad, lay.ugroups, lay.ktiles, lay.threads, lay.step_bytes) == (
        16, 2, 8, 128, 8192)
    assert plan.grid[0] * plan.grid[1] == 256
    for b in (25, 32):
        small = fwd_mma_plan(b, 128)
        assert (small.rows, small.groups, small.grid[0] * small.grid[1]) == (8, 4, 64)
    big = fwd_mma_plan(256, 128)
    assert (big.rows, big.groups, big.grid[0] * big.grid[1]) == (8, 32, 512)


@pytest.mark.parametrize("H", [4, 12, 64, 128])
def test_fwd_mma_plan_runs_eight_rows_at_any_batch(H):
    """The kernel's one instance, 8 rows a cluster, at every batch: as many
    clusters a direction as 8-row groups, the last one partial."""
    for B in range(1, 300):
        plan = fwd_mma_plan(B, H)
        assert (plan.rows, plan.groups) == (FWD_MMA_ROWS, -(-B // FWD_MMA_ROWS))
        assert plan.grid == (plan.cluster * plan.groups, 2)


def _fwd_mma_gates(plan, w, h):
    """The gate products ``(rows, 4H)`` of one cluster (``h``: its rows'
    f32 h, ``(plan.rows, H)``) as ``lstm_fwd_mma_kernel`` computes them,
    written out from its source.  Every CTA's tile pairs store their h into
    slot ``slot_of`` of every n-tile, in the B fragments' layout: warp ks of
    a pair holds row 2tq + ks of lane (g, tq)'s unit, and its lanes 4 (2a +
    ks) + tc gather row 2a + ks of units 2tc, 2tc + 1 by two shuffles.
    Every warp multiplies its two tiles of A fragments (W_hh at the padded
    inputs, ``w_at``) by the slots of its n-tile over its half of the
    k-tiles; a pair's warps add their sums; lane (g, tq) reads the
    accumulators as gates i, f (tile 0) and g, o (tile 1) of unit 8 j + g
    for rows 2tq and 2tq + 1.  One piece: the pieces' products are summed
    by the same fragments."""
    lay = fwd_mma_layout(plan)
    H, C, u, upad, ks_n = plan.H, plan.cluster, plan.units, lay.upad, FWD_MMA_PAIR_WARPS
    n_tiles = plan.rows // 8
    g, tq = np.arange(32) // 4, np.arange(32) % 4

    def h_of(rank, j, nt, unit, row):  # a producer lane's h, zero on padded units
        return np.where(unit < u, h[nt * 8 + row, rank * u + np.minimum(unit, u - 1)], 0)

    slots = np.full((n_tiles, 2 * lay.ktiles, 32, 2), np.nan)  # (lo, hi) halves of a register
    for rank in range(C):
        for j in range(lay.ugroups):
            for nt in range(n_tiles):
                slot = lay.slot_of(rank, j)
                for ks in range(2):
                    held = h_of(rank, j, nt, 8 * j + g, 2 * tq + ks)  # lane (g, tq) of warp ks
                    lanes = np.arange(16)
                    a4, tc = lanes >> 2, lanes & 3
                    to_lane = 4 * (2 * a4 + ks) + tc
                    slots[nt, slot, to_lane, 0] = held[4 * (2 * tc) + a4]
                    slots[nt, slot, to_lane, 1] = held[4 * (2 * tc + 1) + a4]
    assert not np.isnan(slots).any()  # every slot filled

    def w_at(kpad, q, mu):  # W_hh[input of padded index kpad, column of gate q, unit mu]
        src, k = divmod(kpad, upad)
        if k >= u or mu >= u or src >= C:
            return 0.0
        return w[src * u + k, q * H + rank * u + mu]

    gates = np.full((plan.rows, 4 * H), np.nan)
    kt_n = lay.ktiles // ks_n
    for rank in range(C):
        for j in range(lay.ugroups):
            for nt in range(n_tiles):
                acc = np.zeros((2, 16, 8))  # D of each tile (gate column row, batch row), pair summed
                for ks in range(ks_n):
                    for kt in range(ks * kt_n, (ks + 1) * kt_n):
                        b = np.zeros((16, 8))  # B[k][n] from the b0 (slot 2kt) and b1 registers
                        for lane in range(32):
                            for half in range(2):
                                b[2 * tq[lane] + half, g[lane]] = slots[nt, 2 * kt, lane, half]
                                b[8 + 2 * tq[lane] + half, g[lane]] = slots[nt, 2 * kt + 1, lane,
                                                                            half]
                        for t in range(2):
                            a = np.array([[w_at(kt * 16 + k, 2 * t + r // 8, 8 * j + r % 8)
                                           for k in range(16)] for r in range(16)])
                            acc[t] += a @ b
                for lane in range(32):
                    m, r0 = 8 * j + g[lane], nt * 8 + 2 * tq[lane]
                    if m >= u:
                        continue
                    for i in range(2):
                        for q, (t, row) in enumerate(((0, g[lane]), (0, g[lane] + 8),
                                                      (1, g[lane]), (1, g[lane] + 8))):
                            gates[r0 + i, q * H + rank * u + m] = acc[t, row, 2 * tq[lane] + i]
    return gates


@pytest.mark.parametrize("H", [4, 12, 16, 40, 68, 100, 124, 128])
def test_fwd_mma_fragments_compute_the_gate_product(H):
    rng = np.random.default_rng(H + FWD_MMA_ROWS)
    plan = fwd_mma_plan(FWD_MMA_ROWS, H)
    w = rng.standard_normal((H, 4 * H))
    h = rng.standard_normal((FWD_MMA_ROWS, H))
    np.testing.assert_allclose(_fwd_mma_gates(plan, w, h), h @ w, rtol=1e-12, atol=1e-12)


def test_fwd_mma_constants_match_the_cuda_source():
    """The bf16 form's constants, instances, layout and lane mapping, which
    ``fwd_mma_plan``, ``fwd_mma_layout`` and the tests above mirror."""
    src = lstm_cell.SOURCES["lstm_fwd"].read_text()
    declared = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(declared["kPieces"]) == FWD_PIECES
    assert int(declared["kSlotWords"]) == FWD_SLOT_WORDS >= FWD_PIECES
    assert int(declared["kMmaMaxTiles"]) == FWD_MMA_MAX_TILES
    assert int(declared["kPairWarps"]) == FWD_MMA_PAIR_WARPS
    assert set(re.findall(r"lstm_fwd_mma_kernel<(\d+)>;", src)) == {str(FWD_MMA_ROWS)}
    for line in ("upad = (units + 7) / 8 * 8;", "ugroups = upad / 8;",
                 "ktiles = cluster * upad / 16;",
                 "return sizeof(uint32_t) * kSlotWords * (rows / 8) * ktiles * 2 * 32;",
                 "const int ks = warp % kPairWarps, pair = warp / kPairWarps;",
                 "const int grp = pair % lay.ugroups, nt = pair / lay.ugroups;",
                 "const int kt_n = ktiles / kPairWarps, kt0 = ks * kt_n;",
                 "const int a4 = (lane & 15) >> 2, tc = lane & 3;",
                 "float lo = __shfl_sync(kAll, hv, 4 * (2 * tc) + a4);",
                 "float hi = __shfl_sync(kAll, hv, 4 * (2 * tc + 1) + a4);",
                 "const int to_lane = 4 * (2 * a4 + ks) + tc;",
                 "const int m = grp * 8 + g;", "const int r0 = nt * 8 + 2 * tq;",
                 "const int kp = rank * upad + grp * 8;",
                 "const int own_slot = (kp / 16) * 2 + (kp / 8) % 2;",
                 "const int src = kpad / upad, k = kpad - src * upad;",
                 "return w_hh[static_cast<size_t>(src * units + k) * G + q * H + n0 + mu];",
                 "const int qa = 2 * t, qb = 2 * t + 1;"):
        assert line in src, line

#!/usr/bin/env python3
"""What bounds a step of the backward LSTM sweep (``lstm_bwd_kernel`` in
``ml_audio_inpainting_torch/csrc/lstm_bwd.cu``) on one CUDA card.

    python3 -m scripts.torch_lstm_bwd_phases    # from the repo root

Builds timing-only variants of the shipped source, each with one phase of
the step switched off by a text edit of a copy (the kernel itself has no
such switches), and times every variant with CUDA events at B=25 and B=128
(T=417, H=128, both directions).  The variants compute wrong results; only
``all`` is the shipped kernel, and it is checked bitwise against the
wrapper's launch.  Prints one JSON object: ms a launch and µs a step of each
variant, with the card's name and power limit.  Imports nothing of JAX.

Phases: A, the partial dh from the last step's dgates; B, the gate
recomputation of the next step between the cluster barrier's arrive and
wait; C, the elementwise step with its reads of the peers' partials; the
staging of h_prev by ``cp.async``; the cluster barrier.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ml_audio_inpainting_torch.ops.cuda import lstm_cell

T, H = 417, 128
# Text of the shipped step -> its replacement in a variant.
CUT_A = ("    if (s > 0) dh_partials(s);\n", "")
CUT_B = ("    if (s + 1 < T) gate_partials(s + 1);\n", "")
CUT_C = ("    if (c_active) {\n      float dh_carry = 0.0f;",
         "    if (false) {\n      float dh_carry = 0.0f;")
CUT_DSMEM = ("v[r] = r < csize ? *cluster.map_shared_rank(part, r) : 0.0f;",
             "v[r] = r < csize ? part[r] : 0.0f;")
CUT_STAGE = ("    if (s + 2 < T) stage_h(s + 2);", "")
CTA_BARRIER = [("    cluster_arrive();\n", "    __syncthreads();\n"),
               ("    cluster_wait();\n", "    __syncthreads();\n")]
VARIANTS = {
    "all": [],
    "no_A": [CUT_A],
    "no_B": [CUT_B],
    "no_C": [CUT_C],
    "no_dsmem_reads": [CUT_DSMEM],
    "no_staging": [CUT_STAGE],
    "cta_barrier": CTA_BARRIER,
    "no_A_B": [CUT_A, CUT_B],
    "no_A_B_C": [CUT_A, CUT_B, CUT_C],
    "barriers_only": [CUT_A, CUT_B, CUT_C, CUT_STAGE],
}


def variant_sources() -> dict:
    """Variant name -> CUDA source; raises if an edit no longer finds its
    text in the shipped source."""
    shipped = lstm_cell.SOURCES["lstm_bwd"].read_text()
    out = {}
    for name, edits in VARIANTS.items():
        src = shipped
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"variant {name}: {old!r} is not in lstm_bwd.cu exactly once")
            src = src.replace(old, new)
        out[name] = src
    return out


def _build(item) -> tuple:
    name, src = item
    folder = lstm_cell.BUILD_DIR / "phases"
    folder.mkdir(parents=True, exist_ok=True)
    (folder / f"{name}.cu").write_text(src)
    lib = folder / f"lib{name}.so"
    cmd = [lstm_cell._find_nvcc(), *lstm_cell.NVCC_FLAGS, "-o", str(lib), str(folder / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).lstm_bwd_launch
    fn.argtypes = lstm_cell._LAUNCHERS["lstm_bwd"]["lstm_bwd_launch"]
    fn.restype = ctypes.c_int
    return name, fn


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script times the kernel on a card")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    sources = variant_sources()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc a variant, all at once
        launchers = dict(pool.map(_build, sources.items()))
    gen = torch.Generator().manual_seed(0)
    result = {"card": smi, "T": T, "H": H}
    for B in (25, 128):
        xw_f, xw_b = (torch.randn(B, T, 4 * H, generator=gen).cuda() for _ in range(2))
        w_f, w_b = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1).mul(H ** -0.5).cuda()
                    for _ in range(2))
        g = torch.randn(B, T, 2 * H, generator=gen).cuda()
        h, c = lstm_cell.bilstm_forward(xw_f, w_f, xw_b, w_b, with_c=True)
        inputs = (xw_f, w_f, xw_b, w_b, h, c, g)
        shipped = lstm_cell.bilstm_recurrence_backward(*inputs)
        plan = lstm_cell.bwd_plan(B, H)
        stream = torch.cuda.current_stream().cuda_stream
        rows = {}
        for name, fn in launchers.items():
            out = (torch.empty_like(xw_f), torch.empty_like(xw_b))
            ptrs = [t.data_ptr() for t in (*inputs, *out)] + [None, None]  # f32: no dgates

            def launch():
                rc = fn(*ptrs, B, T, H, plan.cluster, plan.ksplit,
                        lstm_cell.DTYPE_CODES[torch.float32], stream)
                if rc != 0:
                    raise RuntimeError(f"variant {name}: CUDA error {rc}")

            for _ in range(3):
                launch()
            torch.cuda.synchronize()
            if name == "all" and not all(torch.equal(x, y) for x, y in zip(out, shipped)):
                raise AssertionError("the unedited copy disagrees with the shipped kernel")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                launch()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 20
            rows[name] = {"ms": ms, "us_per_step": 1e3 * ms / T}
        result[f"B={B}"] = rows
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

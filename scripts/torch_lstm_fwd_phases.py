#!/usr/bin/env python3
"""What bounds a step of the forward LSTM sweep (``lstm_fwd_kernel`` in
``ml_audio_inpainting_torch/csrc/lstm_fwd.cu``) on one CUDA card.

    python3 -m scripts.torch_lstm_fwd_phases    # from the repo root

Builds timing-only variants of the shipped source, each with one phase of
the step cut out by a text edit of a copy (the kernel itself has no such
switches), and times every variant with CUDA events at the serving shapes
(B=32, ``h`` only) and the training shapes (B=25, ``h`` and ``c``), T=417,
H=128, both directions, on the launch plan of ``fwd_plan``.  The variants
compute wrong results; only ``all`` is the shipped kernel, and it is checked
bitwise against the wrapper's launch.  Prints one JSON object: ms a launch
and µs a step of each variant, with the card's name and power limit.
Imports nothing of JAX.

Phases: P, the gate product (the k-slices' dots from the W_hh registers,
and their sums by shuffles; the sums also alone); E, the elementwise step
(the gates' sigmoid and tanh, the gather of a unit's activations by
shuffles, tanh(c)); the stores of h into the peers' shared memory; the
``cp.async`` staging of xw; the cluster barrier (replaced by
``__syncthreads``), or its release alone (``.relaxed``); the global stores
of h and c.  Also the whole step without the launch bounds' register cap.
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
SHAPES = ((32, False), (25, True))  # (B, with c): serving, training
# Text of the shipped step -> its replacement in a variant.
CUT_PRODUCT = ("    for (int i = 0; i < kSpanMax; i += 4) {", "    for (int i = 0; i < 0; i += 4) {")
CUT_REDUCE = ("      for (int o = 1; o < KQ; o <<= 1) acc[r] += __shfl_xor_sync(kAll, acc[r], o);\n", "")
CUT_P = [CUT_PRODUCT, CUT_REDUCE]
CUT_E = [("      const float act = q == 2 ? tanhf(pre) : sigmoid_f(pre);",
          "      const float act = pre;"),
         ("      h[j] = go * tanhf(c[j]);", "      h[j] = go * c[j];")] + [
    (f"      const float g{x} = __shfl_sync(kAll, act, first + {lane}kq);",
     f"      const float g{x} = act;")
    for x, lane in (("i", ""), ("f", "KQ + "), ("g", "2 * KQ + "), ("o", "3 * KQ + "))]
CUT_PEER = ("        for (int p = q; p < csize; p += 4) *cluster.map_shared_rank(h_next + r * hrow, p) = h[j];\n",
            "")
CUT_STAGE = ("    stage_xw(s + 2);", "    cp_async_commit();")
# Without the cluster barrier's release in the loop, a cluster.sync() after
# it keeps every CTA alive while its peers' stores may still land in it.
FINAL_SYNC = ("  }\n}\n\ntemplate <typename Elem, int Rows, int KQ>",
              "  }\n  cluster.sync();\n}\n\ntemplate <typename Elem, int Rows, int KQ>")
CTA_BARRIER = [("    cluster_arrive();\n", "    __syncthreads();\n"),
               ("    cluster_wait();\n", "    __syncthreads();\n"), FINAL_SYNC]
RELAXED = [("barrier.cluster.arrive.release", "barrier.cluster.arrive.relaxed"), FINAL_SYNC]
UNCAPPED = [("__launch_bounds__(kThreads, KQ == 4 ? 4 : 2)", "__launch_bounds__(kThreads)")]
CUT_GLOBAL = ("          if (q == 0) {\n"
              "            h_out[at] = from_f32<Elem>(h[j]);\n"
              "          } else if (c_out != nullptr) {\n"
              "            c_out[at] = from_f32<Elem>(c[j]);\n"
              "          }\n", "")
VARIANTS = {
    "all": [],
    "no_P": CUT_P,  # the gate product: loads, FMAs and the shuffle sums
    "no_reduce": [CUT_REDUCE],  # the shuffle sums alone
    "no_E": CUT_E,  # the elementwise step: transcendentals and the gather
    "no_peer_stores": [CUT_PEER],
    "no_staging": [CUT_STAGE],
    "cta_barrier": CTA_BARRIER,
    "relaxed_arrive": RELAXED,  # the barrier without its release of the peer stores
    "no_global_stores": [CUT_GLOBAL],
    "uncapped_registers": UNCAPPED,  # the same step, registers as ptxas likes
    "no_P_E": CUT_P + CUT_E,
    "barriers_only": CUT_P + CUT_E + [CUT_PEER, CUT_STAGE, CUT_GLOBAL],
}


def variant_sources() -> dict:
    """Variant name -> CUDA source; raises if an edit no longer finds its
    text in the shipped source."""
    shipped = lstm_cell.SOURCES["lstm_fwd"].read_text()
    out = {}
    for name, edits in VARIANTS.items():
        src = shipped
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"variant {name}: {old!r} is not in lstm_fwd.cu exactly once")
            src = src.replace(old, new)
        out[name] = src
    return out


def _build(item) -> tuple:
    name, src = item
    folder = lstm_cell.BUILD_DIR / "fwd_phases"
    folder.mkdir(parents=True, exist_ok=True)
    (folder / f"{name}.cu").write_text(src)
    lib = folder / f"lib{name}.so"
    cmd = [lstm_cell._find_nvcc(), *lstm_cell.NVCC_FLAGS, "-o", str(lib), str(folder / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).lstm_fwd_launch
    fn.argtypes = lstm_cell._LAUNCHERS["lstm_fwd"]["lstm_fwd_launch"]
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
    for B, with_c in SHAPES:
        xw_f, xw_b = (torch.randn(B, T, 4 * H, generator=gen).cuda() for _ in range(2))
        w_f, w_b = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1).mul(H ** -0.5).cuda()
                    for _ in range(2))
        shipped = lstm_cell.bilstm_forward(xw_f, w_f, xw_b, w_b, with_c=with_c)
        plan = lstm_cell.fwd_plan(B, H)
        stream = torch.cuda.current_stream().cuda_stream
        rows = {"plan": {"rows": plan.rows, "cluster": plan.cluster, "ksplit": plan.ksplit,
                         "grid": list(plan.grid)}}
        for name, fn in launchers.items():
            h = torch.empty((B, T, 2 * H), device="cuda")
            c = torch.empty_like(h) if with_c else None
            ptrs = [t.data_ptr() for t in (xw_f, w_f, xw_b, w_b, h)] + [
                None if c is None else c.data_ptr()]

            def launch():
                rc = fn(*ptrs, B, T, H, plan.rows, plan.cluster, plan.ksplit, plan.groups,
                        lstm_cell.DTYPE_CODES[torch.float32], stream)
                if rc != 0:
                    raise RuntimeError(f"variant {name}: CUDA error {rc}")

            for _ in range(3):
                launch()
            torch.cuda.synchronize()
            if name == "all" and not (torch.equal(h, shipped[0])
                                      and (c is None or torch.equal(c, shipped[1]))):
                raise AssertionError("the unedited copy disagrees with the shipped kernel")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                launch()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 20
            rows[name] = {"ms": ms, "us_per_step": 1e3 * ms / T}
        result[f"B={B}{', with c' if with_c else ''}"] = rows
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

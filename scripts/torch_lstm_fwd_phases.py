#!/usr/bin/env python3
"""What bounds a step of the forward LSTM sweep (``csrc/lstm_fwd.cu`` in
``ml_audio_inpainting_torch``) on one CUDA card: the f32 ``lstm_fwd_kernel``
and the bf16 ``lstm_fwd_mma_kernel`` (tensor cores).

    python3 -m scripts.torch_lstm_fwd_phases    # from the repo root

Builds timing-only variants of the shipped source, each with one phase of
a sweep's step cut out by a text edit of a copy (the kernels themselves
have no such switches), and times every variant with CUDA events, on the
form's own launch plan (``fwd_plan``, ``fwd_mma_plan``), T=417, H=128, both
directions: f32 at the serving shapes (B=32, ``h`` only) and the training
shapes (B=25, ``h`` and ``c``); bf16 at the production batch (B=128) and
B=25, ``h`` and ``c``.  The variants compute wrong results; only ``all`` is
the shipped kernel, and it is checked bitwise against the wrapper's launch.
Prints one JSON object: ms a launch and µs a step of each variant, with
the card's name and power limit.  Imports nothing of JAX.

f32 phases: P, the gate product (the k-slices' dots from the W_hh
registers, and their sums by shuffles; the sums also alone); E, the
elementwise step (the gates' sigmoid and tanh, the gather of a unit's
activations by shuffles, tanh(c)); the stores of h into the peers' shared
memory; the ``cp.async`` staging of xw; the cluster barrier (replaced by
``__syncthreads``), or its release alone (``.relaxed``); the global stores
of h and c.  Also the whole step without the launch bounds' register cap.

bf16 phases: P, the tensor-core products (the slots' loads and every
piece's products; also one piece in place of three, which cuts two thirds
of the products and the splits); the named barrier of a tile pair's two
warps, which trade the halves of their sums; E, the elementwise step
(sigmoid, tanh); the shuffles of h into the B fragments' layout; the
slots (their st.async to every CTA and the mbarrier waits for them); the
cluster barrier's arrive with release in place of relaxed; the global
stores of h and c; the global loads of xw.
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
SHAPES = {"f32": ((32, False), (25, True)), "bf16": ((128, True), (25, True))}
# Text of the shipped step -> its replacement in a variant.
# lstm_fwd_kernel (f32).
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
FINAL_SYNC = ("    cluster_wait();\n  }\n}\n", "    cluster_wait();\n  }\n  cluster.sync();\n}\n")
RELEASE = ("barrier.cluster.arrive.release", "barrier.cluster.arrive.relaxed")
CTA_BARRIER = [FINAL_SYNC, ("    cluster_arrive();\n", "    __syncthreads();\n"),
               ("    cluster_wait();\n", "    __syncthreads();\n")]
UNCAPPED = [("__launch_bounds__(kThreads, KQ == 4 ? 4 : 2)", "__launch_bounds__(kThreads)")]
CUT_GLOBAL = ("    if (unit_ok && q < 2) {", "    if (false) {")
VARIANTS = {
    "all": [],
    "no_P": CUT_P,  # the gate product: loads, FMAs and the shuffle sums
    "no_reduce": [CUT_REDUCE],  # the shuffle sums alone
    "no_E": CUT_E,  # the elementwise step: transcendentals and the gather
    "no_peer_stores": [CUT_PEER],
    "no_staging": [CUT_STAGE],
    "cta_barrier": CTA_BARRIER,
    "relaxed_arrive": [RELEASE, FINAL_SYNC],  # the barrier without its release of the peer stores
    "no_global_stores": [CUT_GLOBAL],
    "uncapped_registers": UNCAPPED,  # the same step, registers as ptxas likes
    "no_P_E": CUT_P + CUT_E,
    "barriers_only": CUT_P + CUT_E + [CUT_PEER, CUT_STAGE, CUT_GLOBAL],
}
# lstm_fwd_mma_kernel (bf16, tensor cores).  Every cut keeps the mbarriers'
# accounting whole (a slot sent is a slot expected), so that no variant hangs.
MMA_P = ("      if (i < kt_n) {\n        const uint4 lo", "      if (false) {\n        const uint4 lo")
MMA_ONE_PIECE = ("constexpr int kPieces = 3;", "constexpr int kPieces = 1;")
MMA_E = [(f"    const float g{x} = {fn}(mine.{f} + other.{f} + __bfloat162float(x_now[{q}]));",
          f"    const float g{x} = mine.{f} + other.{f} + __bfloat162float(x_now[{q}]);")
         for x, fn, f, q in (("i", "sigmoid_f", "x", 0), ("f", "sigmoid_f", "y", 1),
                             ("g", "tanhf", "z", 2), ("o", "sigmoid_f", "w", 3))
         ] + [("    const float hv = go * tanhf(c);", "    const float hv = go * c;")]
MMA_EXCHANGE = ("    named_barrier(1 + pair, 32 * kPairWarps);\n", "")
MMA_SHUFFLE = [("      float lo = __shfl_sync(kAll, hv, 4 * (2 * tc) + a4);", "      float lo = hv;"),
               ("      float hi = __shfl_sync(kAll, hv, 4 * (2 * tc + 1) + a4);", "      float hi = hv;")]
# The slots neither sent nor waited for (nor expected).
MMA_SLOTS = [("    if (s + 1 < T) {\n      float lo", "    if (false) {\n      float lo"),
             ("    if (s > 0) mbar_wait(", "    if (false) mbar_wait("),
             ("    if (tid == 0 && s > 0 && s + 1 < T) mbar_expect(",
              "    if (false) mbar_expect("),
             ("    if (T > 1) mbar_expect(bar + 8, step_bytes);", "")]
MMA_RELEASE = ("barrier.cluster.arrive.relaxed", "barrier.cluster.arrive.release")
MMA_GLOBAL = ("    if (m < units && r < rows) {\n      const size_t at",
              "    if (false) {\n      const size_t at")
MMA_LOADS = ("    const bool on = s < T && m < units && r < rows;", "    const bool on = false;")
VARIANTS_MMA = {
    "all": [],
    "no_P": [MMA_P],  # the slots' loads and every piece's products
    "one_piece": [MMA_ONE_PIECE],  # a third of the products and splits
    "no_pair_barrier": [MMA_EXCHANGE],  # the named barrier of a tile pair's two warps
    "no_E": MMA_E,  # the transcendentals
    "no_shuffle": MMA_SHUFFLE,  # the shuffles into the B fragments' layout
    "no_slots": MMA_SLOTS,  # the st.async to the peers and the mbarrier waits
    "release_arrive": [MMA_RELEASE],  # the barrier's arrive with release, as the f32 form's
    "no_global_stores": [MMA_GLOBAL],
    "no_xw_loads": [MMA_LOADS],
    "barriers_only": [MMA_P, *MMA_E, *MMA_SLOTS, MMA_GLOBAL, MMA_LOADS],
}


def variant_sources(form: str = "f32") -> dict:
    """Variant name -> CUDA source of ``form`` (``"f32"`` or ``"bf16"``);
    raises if an edit no longer finds its text in the shipped source."""
    shipped = lstm_cell.SOURCES["lstm_fwd"].read_text()
    variants = VARIANTS_MMA if form == "bf16" else VARIANTS
    out = {}
    for name, edits in variants.items():
        src = shipped
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"variant {name}: {old!r} is not in lstm_fwd.cu exactly once")
            src = src.replace(old, new)
        out[name] = src
    return out


def _build(item) -> tuple:
    (form, name), src = item
    folder = lstm_cell.BUILD_DIR / "fwd_phases"
    folder.mkdir(parents=True, exist_ok=True)
    stem = f"{form}_{name}"
    (folder / f"{stem}.cu").write_text(src)
    lib = folder / f"lib{stem}.so"
    cmd = [lstm_cell._find_nvcc(), *lstm_cell.NVCC_FLAGS, "-o", str(lib), str(folder / f"{stem}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {stem}:\n{proc.stdout}{proc.stderr}")
    return (form, name), ctypes.CDLL(str(lib))


def _launcher(cdll, form: str):
    """The variant's launcher and the arguments after the six pointers, for
    a plan at batch B: (fn, args_of(plan, B))."""
    launchers = lstm_cell._LAUNCHERS["lstm_fwd"]
    if form == "bf16":
        fn = cdll.lstm_fwd_mma_launch
        fn.argtypes = launchers["lstm_fwd_mma_launch"]
        fn.restype = ctypes.c_int
        return fn, lambda plan, B: (B, T, H, plan.rows, plan.cluster, plan.groups)
    fn = cdll.lstm_fwd_launch
    fn.argtypes = launchers["lstm_fwd_launch"]
    fn.restype = ctypes.c_int
    return fn, lambda plan, B: (B, T, H, plan.rows, plan.cluster, plan.ksplit, plan.groups)


def _time(launch, reps: int = 20) -> float:
    """Mean ms of ``launch()`` over ``reps`` launches, by CUDA events, after
    three warm-up launches."""
    for _ in range(3):
        launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script times the kernel on a card")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    sources = {(form, name): src for form in SHAPES
               for name, src in variant_sources(form).items()}
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc a variant, all at once
        libs = dict(pool.map(_build, sources.items()))
    gen = torch.Generator().manual_seed(0)
    result = {"card": smi, "T": T, "H": H}
    for form, shapes in SHAPES.items():
        dtype = torch.bfloat16 if form == "bf16" else torch.float32
        plan_of = lstm_cell.fwd_mma_plan if form == "bf16" else lstm_cell.fwd_plan
        out = result[form] = {}
        for B, with_c in shapes:
            xw_f, xw_b = (torch.randn(B, T, 4 * H, generator=gen).to("cuda", dtype)
                          for _ in range(2))
            w_f, w_b = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1).mul(H ** -0.5)
                        .to("cuda", dtype) for _ in range(2))
            shipped = lstm_cell.bilstm_forward(xw_f, w_f, xw_b, w_b, with_c=with_c)
            plan = plan_of(B, H)
            stream = torch.cuda.current_stream().cuda_stream
            rows = {"plan": {"rows": plan.rows, "cluster": plan.cluster, "ksplit": plan.ksplit,
                             "grid": list(plan.grid)}}
            for (f, name), cdll in libs.items():
                if f != form:
                    continue
                fn, args_of = _launcher(cdll, form)
                h = torch.empty((B, T, 2 * H), device="cuda", dtype=dtype)
                c = torch.empty_like(h) if with_c else None
                ptrs = [t.data_ptr() for t in (xw_f, w_f, xw_b, w_b, h)] + [
                    None if c is None else c.data_ptr()]
                args = args_of(plan, B)

                def launch():
                    rc = fn(*ptrs, *args, stream)
                    if rc != 0:
                        raise RuntimeError(f"variant {form} {name}: CUDA error {rc}")

                for _ in range(3):
                    launch()
                torch.cuda.synchronize()
                if name == "all" and not (torch.equal(h, shipped[0])
                                          and (c is None or torch.equal(c, shipped[1]))):
                    raise AssertionError(f"the unedited {form} copy disagrees with the shipped "
                                         "kernel")
                ms = _time(launch)
                rows[name] = {"ms": ms, "us_per_step": 1e3 * ms / T}
            out[f"B={B}{', with c' if with_c else ''}"] = rows
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

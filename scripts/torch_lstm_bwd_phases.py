#!/usr/bin/env python3
"""What bounds a step of the backward LSTM sweeps in
``ml_audio_inpainting_torch/csrc/lstm_bwd.cu`` on one CUDA card: the f32
``lstm_bwd_kernel`` and the bf16 ``lstm_bwd_mma_kernel`` (tensor
cores).

    python3 -m scripts.torch_lstm_bwd_phases    # from the repo root

Builds timing-only variants of the shipped source, each with one phase of
a sweep's step switched off by a text edit of a copy (the kernels
themselves have no such switches), and times every variant of each form
with CUDA events at B=25 and B=128 (T=417, H=128, both directions), on the
form's own launch plan (``bwd_plan``, ``bwd_mma_plan``).  The variants
compute wrong results; only ``all`` is the shipped kernel, and it is
checked bitwise against the wrapper's launch.  Prints one JSON object: ms a
launch and µs a step of each variant of each form, with the card's name and
power limit.  Imports nothing of JAX.

Phases: A, the partial dh from the last step's dgates (bf16: the tensor-core
product of the dgates' pieces); B, the gate recomputation of the next step
between the cluster barrier's arrive and wait; C, the elementwise step with
its reads of the peers' partials; the staging of h_prev by ``cp.async``;
(bf16) the loads of the next step's c, g and xw and the stores of the last
step's dxw and lo; the cluster barrier.
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
# Text of the shipped step -> its replacement in a variant, for each form.
_F32 = {
    "A": ("    if (s > 0) dh_partials(s);\n", ""),
    "B": ("    if (s + 1 < T) gate_partials(s + 1);\n", ""),
    "C": ("    if (c_active) {\n      float dh_carry = 0.0f;",
          "    if (false) {\n      float dh_carry = 0.0f;"),
    "dsmem": ("v[r] = r < csize ? *cluster.map_shared_rank(part, r) : 0.0f;",
              "v[r] = r < csize ? part[r] : 0.0f;"),
    "stage": ("    if (s + 2 < T) stage_h(s + 2);", ""),
    "barrier": [("    cluster_arrive();\n", "    __syncthreads();\n"),
                ("    cluster_wait();\n", "    __syncthreads();\n")],
}
_BF16 = {
    "A": ("    if (s > 0) dh_mma(s);\n", ""),
    "B": ("    if (s + 1 < T) gate_mma(s + 1);\n", ""),
    "C": ("      if (!c_on[j]) continue;", "      if (true) continue;"),
    "dsmem": ("v[r] = r < csize ? *cluster.map_shared_rank(dhp, r) : 0.0f;",
              "v[r] = r < csize ? dhp[r] : 0.0f;"),
    "stage": ("    if (s + 2 < T) stage(s + 2);", ""),
    "prefetch": ("    if (s + 1 < T) prefetch(s + 1);\n", ""),
    "stores": ("    if (s > 0) flush();  // step s - 1's dxw and lo\n", ""),
    "barrier": [("    cluster_arrive();  // the dh partials of step s are out\n",
                 "    __syncthreads();\n"),
                ("    cluster_wait();  // every peer's are in\n", "    __syncthreads();\n")],
}


def _variants(cut: dict) -> dict:
    one = lambda *names: [e for n in names for e in ([cut[n]] if isinstance(cut[n], tuple)
                                                      else cut[n])]
    out = {"all": [], "no_A": one("A"), "no_B": one("B"), "no_C": one("C"),
           "no_dsmem_reads": one("dsmem"), "no_staging": one("stage"),
           "cta_barrier": one("barrier"), "no_A_B": one("A", "B"),
           "no_A_B_C": one("A", "B", "C"), "barriers_only": one("A", "B", "C", "stage")}
    if "prefetch" in cut:
        out["no_prefetch"] = one("prefetch")
        out["no_stores"] = one("stores")
        out["barriers_only"] = one("A", "B", "C", "stage", "prefetch", "stores")
    return out


VARIANTS = _variants(_F32)  # lstm_bwd_kernel
VARIANTS_BF16 = _variants(_BF16)  # lstm_bwd_mma_kernel
FORMS = {"f32": VARIANTS, "bf16": VARIANTS_BF16}


def variant_sources(form: str = "f32") -> dict:
    """Variant name -> CUDA source for the sweep of ``form`` ("f32" or
    "bf16"); raises if an edit no longer finds its text in the shipped
    source exactly once."""
    shipped = lstm_cell.SOURCES["lstm_bwd"].read_text()
    out = {}
    for name, edits in FORMS[form].items():
        src = shipped
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"{form} variant {name}: {old!r} is not in lstm_bwd.cu "
                                 "exactly once")
            src = src.replace(old, new)
        out[name] = src
    return out


def _build(item) -> tuple:
    (form, name), src = item
    folder = lstm_cell.BUILD_DIR / "phases"
    folder.mkdir(parents=True, exist_ok=True)
    stem = f"{form}_{name}"
    (folder / f"{stem}.cu").write_text(src)
    lib = folder / f"lib{stem}.so"
    cmd = [lstm_cell._find_nvcc(), *lstm_cell.NVCC_FLAGS, "-o", str(lib), str(folder / f"{stem}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {stem}:\n{proc.stdout}{proc.stderr}")
    launcher = "lstm_bwd_launch" if form == "f32" else "lstm_bwd_mma_launch"
    fn = getattr(ctypes.CDLL(str(lib)), launcher)
    fn.argtypes = lstm_cell._LAUNCHERS["lstm_bwd"][launcher]
    fn.restype = ctypes.c_int
    return (form, name), fn


def _time(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script times the kernels on a card")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    items = {(form, name): src for form in FORMS
             for name, src in variant_sources(form).items()}
    with ThreadPoolExecutor(len(items)) as pool:  # one nvcc a variant, all at once
        launchers = dict(pool.map(_build, items.items()))
    gen = torch.Generator().manual_seed(0)
    result = {"card": smi, "T": T, "H": H}
    stream = torch.cuda.current_stream().cuda_stream
    for B in (25, 128):
        xw_f, xw_b = (torch.randn(B, T, 4 * H, generator=gen).cuda() for _ in range(2))
        w_f, w_b = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1).mul(H ** -0.5).cuda()
                    for _ in range(2))
        g = torch.randn(B, T, 2 * H, generator=gen).cuda()
        for form, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            layer = [t.to(dtype) for t in (xw_f, w_f, xw_b, w_b)]
            h, c = lstm_cell.bilstm_forward(*layer, with_c=True)
            inputs = (*layer, h, c, g.to(dtype))
            shipped = lstm_cell.bilstm_recurrence_backward(*inputs, dgates=True)
            rows = {}
            for (f, name), fn in launchers.items():
                if f != form:
                    continue
                out = [torch.empty_like(t) for t in shipped if t is not None]
                ptrs = [t.data_ptr() for t in (*inputs, *out)]
                if form == "f32":
                    plan = lstm_cell.bwd_plan(B, H)
                    args = (*ptrs, B, T, H, plan.cluster, plan.ksplit, stream)
                else:
                    plan = lstm_cell.bwd_mma_plan(B, H)
                    args = (*ptrs, B, T, H, plan.rows, plan.cluster, plan.ksplit, stream)

                def launch(args=args, name=name):
                    rc = fn(*args)
                    if rc != 0:
                        raise RuntimeError(f"{form} variant {name}: CUDA error {rc}")

                ms = _time(launch)
                if name == "all" and not all(
                        torch.equal(x, y) for x, y in zip(out, (t for t in shipped if t is not None))):
                    raise AssertionError(f"the unedited {form} copy disagrees with the shipped kernel")
                rows[name] = {"ms": ms, "us_per_step": 1e3 * ms / T}
            result[f"{form} B={B}"] = rows
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

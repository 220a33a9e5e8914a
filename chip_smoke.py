#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It imports the port (``src/repro_torch``) and nothing of the JAX package.
Each phase prints one line; any failure raises and exits non-zero:

1. device — the card's name, and ``nvidia-smi``'s name and power limit on a
   line of its own;
2. build — the CUDA kernels built with ``nvcc`` for sm_90a, with the
   registers, shared memory and spills that ``-Xptxas -v`` reports;
3. kernels — each kernel against its plain PyTorch version at the main
   path's shape and at a ragged one, in float32 and bfloat16, with CUDA-event
   times of the kernel, the plain version and one library call (a yardstick
   only: the port never calls it) beside the card's bound;
4. main path — the paper's Fig. 2 DAG (16 units of 4096x4096 float32) traced
   and run on the sequential oracle and on the threaded work-stealing
   executor: threaded == sequential bit for bit, each ``mul`` against the
   plain matmul of its inputs, and 16 kernel launches per run.

Then one JSON line of the kernels, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a card, or outside a checkout, it prints no result and exits 1.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peaks (NVIDIA data sheet, dense): float32 on the CUDA
# cores, bf16 on the tensor cores; HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
# tests/test_kernels.py's matmul tolerances, applied to out / sqrt(K): the
# inputs are standard normal, so the products grow like sqrt(K)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

N_TASKS, SIZE, N_WORKERS = 16, 4096, 4          # the main path's DAG
KERNEL_SHAPES = [(SIZE, SIZE, SIZE), (1000, 1531, 777)]   # (M, N, K)
REPS = 10


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def line(tag: str, payload) -> None:
    print(f"{tag}: {json.dumps(payload)}", flush=True)


def phase_device(torch) -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    line("device", {"kind": name, "count": torch.cuda.device_count(),
                    "capability": list(torch.cuda.get_device_capability(0)),
                    "torch": torch.__version__, "cuda": torch.version.cuda,
                    "nvidia_smi": smi})
    return name


def phase_build() -> None:
    from repro_torch.kernels import _build
    cached = (_build.build_dir() / "libkernels.so").exists()
    t0 = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - t0
    kernels, entry = [], None
    for text in _build.ptxas_report().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", text)
        if m:
            entry = {"entry": m.group(1)}
            kernels.append(entry)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      text)
        if m:
            entry["spill_stores"], entry["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", text)
        if m:
            entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", text)
            entry["smem_bytes"] = int(m.group(1)) if m else 0
    if not kernels:
        fail(f"no ptxas report found:\n{_build.ptxas_report()}")
    line("build", {"seconds": seconds, "cached": cached,
                   "dir": str(_build.build_dir().relative_to(ROOT)),
                   "ptxas": kernels})


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(M: int, N: int, K: int, dtype: str, itemsize: int):
    """Least time the card could take: operations at the dtype's peak or
    each input read and the output written once at HBM bandwidth."""
    ops_ms = 2.0 * M * N * K / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = (M * K + K * N + M * N) * itemsize / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def close(torch, got, want, K: int, dtype: str):
    """(max abs error, max error of out/sqrt(K), within tolerance?)"""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    s = math.sqrt(max(K, 1))
    ok = torch.allclose(g / s, w / s, rtol=TOL[dtype], atol=TOL[dtype])
    return err, err / s, ok


def phase_kernels(torch) -> list:
    from repro_torch.kernels import matmul as mm, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for M, N, K in KERNEL_SHAPES:
            x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
            y = torch.randn(K, N, generator=gen, device="cuda").to(dtype)
            got = mm.matmul(x, y)
            want = ref.matmul(x, y)
            torch.cuda.synchronize()
            err, norm_err, ok = close(torch, got, want, K, dname)
            if not ok:
                fail(f"matmul {dname} {M}x{N}x{K}: kernel disagrees with "
                     f"the plain version, max |err|/sqrt(K) = {norm_err}")
            # the library call against the same plain version, so a zero
            # error above can be read beside one the comparison does see
            lib_err = close(torch, torch.matmul(x, y), want, K, dname)[0]
            b_ms, b_by = bound(M, N, K, dname, x.element_size())
            checks.append({
                "shape": [M, N, K], "dtype": dname, "max_abs_err": err,
                "max_err_over_sqrt_k": norm_err, "tol": TOL[dname],
                "library_max_abs_err": lib_err,
                "ms": cuda_ms(torch, lambda: mm.matmul(x, y)),
                "plain_ms": cuda_ms(torch, lambda: ref.matmul(x, y)),
                "library_ms": cuda_ms(torch, lambda: torch.matmul(x, y)),
                "bound_ms": b_ms, "bound_by": b_by})
            del x, y, got, want
    line("kernels_vs_plain", checks)
    return checks


def phase_main_path(torch, checks: list) -> int:
    import numpy as np
    from repro_torch.interop import tensor_from_numpy
    from repro_torch.kernels import matmul as mm, ref
    from repro_torch.workloads import run_matrix_dag

    def bits(t):
        return t.view(torch.int32 if t.element_size() == 4 else torch.int16)

    torch.cuda.reset_peak_memory_stats()
    mm.matmul.launches = 0
    graph, seq, rep_seq = run_matrix_dag(N_TASKS, SIZE, 1)
    seq_launches = mm.matmul.launches
    _, par, rep_par = run_matrix_dag(N_TASKS, SIZE, N_WORKERS)
    launches = mm.matmul.launches
    n_mul = sum(1 for n in graph if n.name == "mul")
    if n_mul != N_TASKS or seq_launches != n_mul \
            or launches - seq_launches != n_mul:
        fail(f"expected {n_mul} kernel launches per run, got "
             f"{seq_launches} and {launches - seq_launches}")
    if len(graph) != 3 * N_TASKS + 1 or set(seq) != set(par):
        fail("the two runs computed different node sets")
    for tid, a in seq.items():
        b = par[tid]
        same = (torch.equal(bits(a), bits(b)) if isinstance(a, torch.Tensor)
                else a == b)
        if not same:
            fail(f"threaded != sequential at {graph.nodes[tid].name}#{tid}")
    worst = 0.0
    for node in graph:
        if node.name != "mul":
            continue
        x, y = (seq[d] for d in node.deps)
        _, norm_err, ok = close(torch, seq[node.tid], ref.matmul(x, y),
                                SIZE, "float32")
        worst = max(worst, norm_err)
        if not ok:
            fail(f"mul#{node.tid} disagrees with the plain matmul: "
                 f"max |err|/sqrt(K) = {norm_err}")
    total = seq[graph.outputs[0]]
    if not math.isfinite(total):
        fail(f"reduce is not finite: {total}")
    peak = torch.cuda.max_memory_allocated()
    del seq, par

    # where the time goes: one gen is a host numpy draw, then a copy to
    # the card; timed apart, one at a time, on the host's clock
    draw_s = copy_s = 0.0
    for seed in range(4):
        t0 = time.perf_counter()
        a = np.random.default_rng(seed).standard_normal((SIZE, SIZE),
                                                        dtype=np.float32)
        t1 = time.perf_counter()
        tensor_from_numpy(a, "cuda")
        torch.cuda.synchronize()
        draw_s += t1 - t0
        copy_s += time.perf_counter() - t1
    draw_ms, copy_ms = draw_s / 4 * 1e3, copy_s / 4 * 1e3
    gen_ms = draw_ms + copy_ms
    mul_ms = next(c["ms"] for c in checks
                  if c["dtype"] == "float32" and c["shape"] == [SIZE] * 3)
    seq_s = rep_seq["wall_time"]
    line("main_path", {
        "units": N_TASKS, "size": SIZE, "nodes": len(graph),
        "workers": N_WORKERS, "launches_per_run": n_mul,
        "seq_wall_s": seq_s, "threaded_wall_s": rep_par["wall_time"],
        "threaded_stats": rep_par["stats"],
        "threaded_equals_sequential": True, "reduce": total,
        "max_mul_err_over_sqrt_k": worst, "peak_device_bytes": peak,
        "gen_ms_each": gen_ms, "gen_draw_ms_each": draw_ms,
        "gen_copy_ms_each": copy_ms, "mul_kernel_ms_each": mul_ms,
        "seq_share_gen": 2 * N_TASKS * gen_ms / 1e3 / seq_s,
        "seq_share_mul": N_TASKS * mul_ms / 1e3 / seq_s})
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    # the plain versions are IEEE float32 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = phase_device(torch)
    phase_build()
    checks = phase_kernels(torch)
    launches = phase_main_path(torch, checks)
    main_check = next(c for c in checks
                      if c["dtype"] == "float32" and c["shape"] == [SIZE] * 3)
    print(json.dumps({"kernels": [{
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul_pallas.py:45",
        "launches": launches,
        "max_abs_err": main_check["max_abs_err"],
        "ms": main_check["ms"], "plain_ms": main_check["plain_ms"],
        "bound_ms": main_check["bound_ms"],
        "bound_by": main_check["bound_by"],
        "library_ms": main_check["library_ms"],
        "shape": main_check["shape"], "dtype": main_check["dtype"],
        "checks": checks}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

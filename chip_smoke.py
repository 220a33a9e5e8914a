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
   path's shape, at a ragged one and at an aligned one that is no tile
   multiple, in float32 and bfloat16, with CUDA-event times of the kernel,
   the plain version and one library call (a yardstick only: the port never
   calls it) beside the card's bound; each check names its route, ``wgmma``
   (bf16 on the tensor cores, fed by TMA) or ``simt`` (the CUDA cores), and
   its load variant (``tma``; ``vector`` or ``scalar`` for simt);
4. main path — the paper's Fig. 2 DAG (16 units of 4096x4096 float32) traced
   and run on the sequential oracle and on the threaded work-stealing
   executor: threaded == sequential bit for bit, each ``mul`` against the
   plain matmul of its inputs, and 16 kernel launches per run;
4b. main path on the process backend — the same DAG on
   ``make_executor("process")`` with 4 spawned worker processes, three
   times: fusion off, fusion on, and fusion on with worker 1 SIGKILLed after
   its second super-task (lineage recovery re-runs what it held).  Each run
   equals phase 4's sequential run bit for bit; its line gives the wall,
   ``/dev/shm``'s size, the data plane's transport, the fusion and
   control-plane counters, the bytes moved, the recomputed super-tasks,
   the seconds to the first completed task (spawn, torch import, CUDA
   context, kernel library) and to the last (the rest of the wall is the
   final collection), and the workers' summed seconds in super-tasks.
   Its ``mul`` launches (tasks run plus recomputed) count in the matmul
   entry's ``launches``;
4c. main path through the gateway — an in-process ``GatewayService`` over
   a resident pool of 4 spawned workers, and tenants that connect over
   localhost TCP: a cold job with every output, two tenants' jobs at once
   with ``outputs_only``, a tenant whose store quota is below one job's
   declared bytes (a typed ``QuotaExceeded``, nothing admitted), and two
   tenants across a SIGKILL of worker 1.  Every job equals phase 4's
   sequential run bit for bit; its line gives the wall as the client saw
   it, the gateway's submit-to-dispatch and submit-to-gather seconds, the
   result frame's bytes and seconds, the pool's start-up, and the job's own
   kernel launches and tasks run, which must agree (simt, vector loads);
5. ssm_scan — the selective-scan kernel against its plain version at the
   long-prefill shape (1x2048x8192, N = 16), a decode step (S = 1, with
   ``h0``) and a ragged shape (3x1000x1000, with ``h0``), in float32 and
   bfloat16, with CUDA-event times beside the card's bound;
6. serve — falcon-mamba-7b at full width (64 layers, 7,272,665,088
   float32 parameters drawn on the card from a seed) served by the port's
   launcher, ``repro_torch.launch.serve.main``, with a traced request on
   the threaded executor: 4 requests, 28 decode steps, the traced tokens a
   prefix of request 0's, and 64 scan launches per forward;
6b. serve on the process backend — the launcher with ``--reduced
   --backend process --graph-workers 2``: the traced request runs on two
   spawned workers, each drawing the reduced model from the seed and
   launching the scan kernel there; the traced tokens a prefix of request
   0's;
6c. serve through the gateway — a 1-worker spawned gateway, and the
   launcher at full width with ``--gateway``: the traced request runs in
   the pool's worker (192 scan launches there), its tokens those of phase
   6's thread backend; the pool is stopped before the next model;
7. long prefill — one 2048-token prompt through the prefill step and 8
   greedy decode steps, once with the scan kernel and once with its plain
   version on the same tokens: last-position logits within ``LOGIT_TOL``;
8. flash_attention — the flash-attention kernels against their plain
   version at qwen2-7b's long prefill (q 1x28x2048x128, k, v 1x4x2048x128,
   causal), a served prefill (S = 12), the reduced qwen2-7b prefill of
   phase 9b's workers (q 1x4x12x32, 2 kv heads), a ragged shape
   (2x8x1000x64, 2 kv heads), a cross-shaped one (Sq 300, Sk 777, not
   causal) and one with D = 72: float32 (the simt route), bf16 (wgmma) and
   bf16 through the simt route (q, k, v one element past a 16-byte
   boundary), each launched twice (the same bits), with CUDA-event times of
   the kernel, the plain version and ``scaled_dot_product_attention`` beside
   the card's bound, and the route of each check;
9. serve — falcon-mamba-7b's parameters freed, qwen2-7b at full width
   (28 layers, 7,615,616,512 float32 parameters drawn on the card from a
   seed) served by the same launcher and argv: 28 decode steps, the traced
   tokens a prefix of request 0's, 28 flash launches per prefill, all on
   the route that ``kernels/flash_attention.py::route`` gives the path's
   compute dtype and head dim (wgmma in bf16), and none per decode step;
9b. phase 6b for qwen2-7b (the flash kernel in the workers' prefill; the
   reduced config computes in float32, so those launches are simt);
9c. phase 6c for qwen2-7b (28 flash launches in the worker, all wgmma);
10. long prefill — phase 7 for qwen2-7b, with the flash kernel and with its
   plain version: 28 launches in the kernel run, all on the wgmma route,
   none in the plain one; then the same on the same parameters at
   ``compute_dtype="float32"``, the full-width path of the simt route: 28
   launches, all simt.  Each long-prefill line gives the prefill's seconds,
   decode ms/step, peak device memory, and the path kernel's own device time
   within the prefill (CUDA events around each launch).

With ``--profile`` it also profiles one decode step and two prefills of
each served model (device time by kernel, device busy share, and the
device time of the port's own kernels).

Then one JSON line of the kernels (``flash_attention``, headed by its
wgmma kernel, counts the wrapper's launches on both routes;
``flash_attention_simt`` is the CUDA-core kernel and its launches), and
last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a card, or outside a checkout, it prints no result and exits 1.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import secrets
import subprocess
import sys
import threading
import time
import types
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
# (M, N, K): the main shape, a ragged one (bf16 keeps the CUDA cores: its
# rows are not 16-byte aligned) and an aligned one that no tile divides
KERNEL_SHAPES = [(SIZE, SIZE, SIZE), (1000, 1531, 777), (1000, 1528, 776)]
REPS = 10
# phase 4b: (fuse, fail_worker) of the three process-backend runs
PROCESS_RUNS = [("off", None), ("auto", None), ("auto", (1, 2))]
# seconds without a completed task before a run fails; the first one waits
# for spawned interpreters to import torch and open a CUDA context
PROCESS_TIMEOUT = 120.0

# the serve paths: falcon-mamba-7b and qwen2-7b at full width, the JAX
# launcher's defaults for prompts (4-12 tokens) and --max-len 64
ARCH, N_PARAMS = "falcon-mamba-7b", 7_272_665_088
DENSE_ARCH, DENSE_N_PARAMS = "qwen2-7b", 7_615_616_512
SERVE_ARGS = ["--requests", "4", "--slots", "2", "--max-new", "8",
              "--show-graph", "--backend", "thread"]
SERVE_MAX_LEN = 64               # serve.py's --max-len default
SERVE_DECODE_STEPS = 28          # 4 requests x 7 decode steps each
SERVE_FORWARDS = 3 + 4 + 28      # traced request + prefills + decode steps
SERVE_PREFILLS = 1 + 4           # traced request + requests
# (Bsz, S, D, N, with h0): the long prefill, one decode step and one
# served prefill (from the cache's zero state) of falcon-mamba-7b, and a
# ragged shape
SCAN_SHAPES = [(1, 2048, 8192, 16, False), (1, 1, 8192, 16, True),
               (1, 12, 8192, 16, True), (3, 1000, 1000, 16, True)]
# tests/test_kernels.py's ssm tolerances (rtol = atol)
SCAN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# (B, H, KH, Sq, Sk, D, causal): qwen2-7b's long prefill and a served
# prefill, the reduced qwen2-7b's prefill (phase 9b's workers, float32), a
# ragged shape, a cross-shaped one and one whose D is a multiple of 8 but
# not of 16
FLASH_SHAPES = [(1, 28, 4, 2048, 2048, 128, True),
                (1, 28, 4, 12, 12, 128, True),
                (1, 4, 2, 12, 12, 32, True),
                (2, 8, 2, 1000, 1000, 64, True),
                (1, 8, 2, 300, 777, 128, False),
                (1, 4, 2, 200, 333, 72, True)]
# phases 6b and 9b: the serve traffic with the traced request on cluster
# worker processes (see phase_serve_process)
PROCESS_SERVE_ARGS = ["--requests", "4", "--slots", "2", "--max-new", "8",
                      "--show-graph", "--backend", "process"]
# phases 6c and 9c: the same traffic, the traced request on a gateway's pool
GATEWAY_SERVE_ARGS = ["--requests", "4", "--slots", "2", "--max-new", "8",
                      "--show-graph"]
LONG_PROMPT, LONG_DECODE = 2048, 8
LONG_MAX_LEN = LONG_PROMPT + LONG_DECODE + 1     # the long run's KV cache
# Kernel and plain version agree to the last bits of float32, but the model
# rounds each layer's scan or attention output to bf16, so a last-bit
# difference can flip a bf16 rounding and grow through the depth.  The
# logits have about unit scale (printed); a broken kernel moves them by
# whole units, this drift by a small fraction of one.
LOGIT_TOL = 0.5


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
    kernels, entry, source = [], None, None
    for text in _build.ptxas_report().splitlines():
        if text.startswith("== "):
            source, entry = text[3:].strip(), None
            continue
        m = re.search(r"Compiling entry function '(\S+)'", text)
        if m:
            entry = {"source": source, "entry": m.group(1)}
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
    sources = {k["source"] for k in kernels}
    if sources != {"matmul.cu", "matmul_wgmma.cu", "ssm_scan.cu",
                   "flash_attention.cu", "flash_attention_wgmma.cu"} or \
            any("registers" not in k for k in kernels):
        fail(f"no ptxas report for every kernel:\n{_build.ptxas_report()}")
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


@contextlib.contextmanager
def timed_launches(torch, module, name: str):
    """Within the block, every call that ``kernels/ops.py`` makes of the
    kernel wrapper ``module.<name>`` is bracketed by CUDA events on the
    current stream; yields the list of (start, end) pairs.  Only ops.py's
    reference to the module is swapped: the wrapper itself, and the launch
    counts it keeps on its own function object, are untouched."""
    from repro_torch.kernels import ops
    alias = next(a for a, val in vars(ops).items() if val is module)
    inner = getattr(module, name)
    events = []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    setattr(ops, alias, types.SimpleNamespace(**{name: timed}))
    try:
        yield events
    finally:
        setattr(ops, alias, module)


def events_ms(torch, events) -> float:
    """Device milliseconds between each pair of events, summed."""
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events)


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
            # fresh allocations: 16-byte aligned
            path = mm.route(dtype, N, K)
            loads = mm.variant(dtype, N, K)
            before = mm.matmul.route_launches[path]
            got = mm.matmul(x, y)
            want = ref.matmul(x, y)
            torch.cuda.synchronize()
            if mm.matmul.route_launches[path] != before + 1:
                fail(f"matmul {dname} {M}x{N}x{K}: no launch on the "
                     f"{path} route")
            err, norm_err, ok = close(torch, got, want, K, dname)
            if not ok:
                fail(f"matmul {dname} {M}x{N}x{K} ({path}, {loads}): kernel "
                     f"disagrees with the plain version, max "
                     f"|err|/sqrt(K) = {norm_err}")
            # the library call against the same plain version, so a zero
            # error above can be read beside one the comparison does see
            lib_err = close(torch, torch.matmul(x, y), want, K, dname)[0]
            b_ms, b_by = bound(M, N, K, dname, x.element_size())
            checks.append({
                "shape": [M, N, K], "dtype": dname, "route": path,
                "variant": loads, "max_abs_err": err,
                "max_err_over_sqrt_k": norm_err, "tol": TOL[dname],
                "library_max_abs_err": lib_err,
                "ms": cuda_ms(torch, lambda: mm.matmul(x, y)),
                "plain_ms": cuda_ms(torch, lambda: ref.matmul(x, y)),
                "library_ms": cuda_ms(torch, lambda: torch.matmul(x, y)),
                "bound_ms": b_ms, "bound_by": b_by})
            c = checks[-1]
            print(f"matmul {dname} {M}x{N}x{K} ({path}, {loads} loads): "
                  f"err/sqrt(K) {norm_err:.3g} (tol {TOL[dname]}) | kernel "
                  f"{c['ms']:.4f} ms | plain {c['plain_ms']:.4f} ms | "
                  f"torch.matmul {c['library_ms']:.4f} ms | bound "
                  f"{b_ms:.4f} ms ({b_by})", flush=True)
            del x, y, got, want
    line("kernels_vs_plain", checks)
    return checks


def _bits(torch, t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _same(torch, a, b) -> bool:
    """Bit for bit equal: tensors by their bits, other values by ``==``."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape
                and a.dtype == b.dtype and a.device == b.device
                and torch.equal(_bits(torch, a), _bits(torch, b)))
    return a == b


def phase_main_path(torch, checks: list):
    """Phase 4; returns the kernel launches, the graph and the sequential
    run's values (phase 4b's reference)."""
    import numpy as np
    from repro_torch.interop import tensor_from_numpy
    from repro_torch.kernels import matmul as mm, ref
    from repro_torch.workloads import run_matrix_dag

    torch.cuda.reset_peak_memory_stats()
    _reset(mm.matmul)
    graph, seq, rep_seq = run_matrix_dag(N_TASKS, SIZE, 1)
    seq_launches = mm.matmul.launches
    _, par, rep_par = run_matrix_dag(N_TASKS, SIZE, N_WORKERS)
    launches = mm.matmul.launches
    n_mul = sum(1 for n in graph if n.name == "mul")
    if n_mul != N_TASKS or seq_launches != n_mul \
            or launches - seq_launches != n_mul:
        fail(f"expected {n_mul} kernel launches per run, got "
             f"{seq_launches} and {launches - seq_launches}")
    if mm.matmul.route_launches != {"wgmma": 0, "simt": launches}:
        fail(f"float32 mul launches by route: {mm.matmul.route_launches}")
    if len(graph) != 3 * N_TASKS + 1 or set(seq) != set(par):
        fail("the two runs computed different node sets")
    for tid, a in seq.items():
        if not _same(torch, a, par[tid]):
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
    del par

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
    return launches, graph, seq


def shm_bytes():
    """Size and free bytes of ``/dev/shm`` ((0, 0) where there is none)."""
    try:
        st = os.statvfs("/dev/shm")
    except OSError:
        return 0, 0
    return st.f_blocks * st.f_frsize, st.f_bavail * st.f_frsize


def phase_process_path(torch, graph, seq) -> int:
    """Phase 4b: phase 4's traced DAG on the cluster runtime's spawned
    workers (a forked child cannot use CUDA once this process has); returns
    the matmul launches of its runs as the workers counted them.  Each
    worker reports its launches with every ``done`` and the executor sums
    them; a run fails unless they equal the ``mul`` tasks that the
    executor saw run (every ``mul`` once, plus those in recomputed
    super-tasks), all on the simt route with vector loads, and this process
    launched none.

    A ``/dev/shm`` smaller than a value passes the shared-memory probe and
    then kills the worker that writes the segment (SIGBUS).  The final
    collection publishes every value at once and a recovery publishes again
    what it recomputes, so unless ``/dev/shm`` has room for twice the run's
    values the runs name ``transport="sock"`` (unix sockets) and say so."""
    from repro_torch.cluster import serde
    from repro_torch.config import ClusterConfig
    from repro_torch.core import make_executor
    from repro_torch.core.fusion import fuse
    values = sum(n.out_bytes for n in graph)
    shm_total, shm_free = shm_bytes()
    room = serde.shm_available() and shm_free >= 2 * values
    transport = "auto" if room else "sock"
    n_mul = sum(1 for n in graph if n.name == "mul")
    driver = _counters()["matmul"]
    total = 0
    for spec, fail_worker in PROCESS_RUNS:
        _reset(driver)
        config = ClusterConfig(n_workers=N_WORKERS, start_method="spawn",
                               fuse=spec, fail_worker=fail_worker,
                               transport=transport,
                               progress_timeout=PROCESS_TIMEOUT)
        ex = make_executor("process", N_WORKERS, config=config)
        t0 = time.perf_counter()
        try:
            got = ex.run(graph)
        finally:
            ex.close()
        wall = time.perf_counter() - t0
        stats = ex.stats
        what = f"process backend, fuse={spec}, fail_worker={fail_worker}"
        if set(got) != set(seq):
            fail(f"{what}: computed another node set")
        for tid, want in seq.items():
            if not _same(torch, got[tid], want):
                fail(f"{what}: {graph.nodes[tid].name}#{tid} differs from "
                     f"the sequential run")
        plan = fuse(graph, spec)
        if plan.n_clusters != stats["n_clusters"]:
            fail(f"{what}: {stats['n_clusters']} super-tasks, the plan has "
                 f"{plan.n_clusters}")
        redo = [m for ev in ex.recovery_events for c in ev["plan"]
                for m in plan.members[c] if graph.nodes[m].name == "mul"]
        if fail_worker is None and (stats["failures"] or
                                    stats["recomputed"]):
            fail(f"{what}: {stats['failures']} worker deaths, "
                 f"{stats['recomputed']} recomputed super-tasks")
        if fail_worker is not None and (stats["failures"] != 1 or
                                        stats["recomputed"] < 1):
            fail(f"{what}: {stats['failures']} worker deaths and "
                 f"{stats['recomputed']} recomputed super-tasks, expected "
                 f"1 and at least 1")
        if stats["n_speculative"]:
            fail(f"{what}: {stats['n_speculative']} speculative runs")
        ran = stats["tasks_run"].get("mul", 0)
        if ran != n_mul + len(redo):
            fail(f"{what}: the executor saw {ran} mul tasks run, expected "
                 f"{n_mul} plus {len(redo)} recomputed")
        in_workers = stats["kernel_launches"]
        launches = in_workers.get("matmul", 0)
        want = {"matmul": ran, "matmul/simt": ran, "matmul/vector": ran}
        if in_workers != want:
            fail(f"{what}: the workers launched {in_workers}, expected "
                 f"{want}")
        if driver.launches:
            fail(f"{what}: this process launched {driver.launches} "
                 f"matmuls")
        total += launches
        line("process_path", {
            "fuse": spec, "fail_worker": fail_worker, "workers": N_WORKERS,
            "start_method": ex.start_method, "nodes": len(graph),
            "wall_s": wall,
            "first_done_s": stats["first_done_s"],
            "last_done_s": stats["last_done_s"],
            # the workers' own seconds in super-tasks (inputs resolved,
            # members run), summed over the completed ones
            "worker_task_s": sum(ex.last_trace.tasks.values()),
            "transport_requested": transport,
            "transport_used": ex.transport_used,
            "transport_note": None if room else
            f"/dev/shm cannot hold twice the run's {values} bytes of "
            f"values, so the run names transport='sock'",
            "dev_shm_bytes": shm_total, "dev_shm_free_bytes": shm_free,
            "values_bytes": values,
            **{k: stats[k] for k in (
                "n_clusters", "tasks_fused", "dispatched", "control_msgs",
                "control_frames", "dispatch_overhead_s", "bytes_direct",
                "bytes_driver", "bytes_moved", "transfers_direct",
                "transfers_driver", "recomputed", "failures")},
            "tasks_run": stats["tasks_run"], "recomputed_muls": len(redo),
            "worker_kernel_launches": in_workers,
            "equals_sequential": True, "reduce": got[graph.outputs[0]]})
        del got
    return total


def _wait_all(futs: dict, submitted: dict, timeout: float) -> dict:
    """Waits for every future; returns each one's seconds from its submit
    to its result in this process (the client's wall)."""
    walls = {}

    def wait(key):
        futs[key].exception(timeout)
        walls[key] = time.perf_counter() - submitted[key]

    threads = [threading.Thread(target=wait, args=(k,)) for k in futs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return walls


def phase_gateway_path(torch, graph, seq) -> int:
    """Phase 4c: phase 4's DAG through the multi-tenant gateway, whose
    resident pool spawns 4 workers once for all its jobs; returns the
    matmul launches of its jobs as their workers reported them.  Every job
    fails the phase unless it equals the sequential run bit for bit (all
    values, or with ``outputs_only`` the ``reduce``), its own matmul
    launches equal its own ``mul`` tasks run, all on the simt route with
    vector loads, and this process launched none.

    Two jobs are in flight at once in runs 2 and 4, so unless ``/dev/shm``
    has room for twice the values of both, the pool names
    ``transport="sock"`` and says so (see phase 4b)."""
    from repro_torch.cluster import serde
    from repro_torch.config import ClusterConfig
    from repro_torch.gateway import (GatewayService, QuotaExceeded,
                                     TenantQuota, connect)
    values = sum(n.out_bytes for n in graph)
    shm_total, shm_free = shm_bytes()
    room = serde.shm_available() and shm_free >= 2 * 2 * values
    transport = "auto" if room else "sock"
    n_mul = sum(1 for n in graph if n.name == "mul")
    reduce_tid = graph.outputs[0]
    token = secrets.token_hex(16)
    driver = _counters()["matmul"]
    _reset(driver)
    config = ClusterConfig(n_workers=N_WORKERS, start_method="spawn",
                           fuse="auto", transport=transport, token=token,
                           progress_timeout=PROCESS_TIMEOUT)
    # the thin tenant's store quota is one byte short of one job's values
    gw = GatewayService(config, quotas={
        "thin": TenantQuota(max_store_bytes=values - 1)})
    t_start = time.perf_counter()
    gw.start()
    total = n_jobs = 0
    clients = {}

    def client(tenant):
        if tenant not in clients:
            clients[tenant] = connect(gw.address, token=token, tenant=tenant)
        return clients[tenant]

    def run(what, tenants, during=None):
        """Submits the DAG for each tenant at once (``tenants`` maps each
        to its ``outputs_only``), waits for all, checks and prints each
        job; returns the futures and their submit times."""
        nonlocal total, n_jobs
        futs, submitted = {}, {}
        t0 = time.perf_counter()
        for tenant, outputs_only in tenants.items():
            submitted[tenant] = time.perf_counter()
            futs[tenant] = client(tenant).submit(
                graph, outputs_only=outputs_only, label=f"{what}-{tenant}")
        if during is not None:
            during(futs)
        walls = _wait_all(futs, submitted, 4 * PROCESS_TIMEOUT)
        together = time.perf_counter() - t0
        for tenant, fut in futs.items():
            got = fut.result(0)
            outputs_only = tenants[tenant]
            job = f"{what} job of tenant {tenant!r}"
            want = {reduce_tid} if outputs_only else set(seq)
            if set(got) != want:
                fail(f"{job}: returned {len(got)} values, expected "
                     f"{len(want)}")
            for tid in want:
                if not _same(torch, got[tid], seq[tid]):
                    fail(f"{job}: {graph.nodes[tid].name}#{tid} differs "
                         f"from the sequential run")
            stats = fut.stats
            ran = stats["tasks_run"].get("mul", 0)
            if ran < n_mul or (stats["recomputed"] == 0 and ran != n_mul):
                fail(f"{job}: ran {ran} mul tasks, {stats['recomputed']} "
                     f"super-tasks recomputed, for {n_mul} mul nodes")
            in_workers = stats["kernel_launches"]
            if in_workers != {"matmul": ran, "matmul/simt": ran,
                              "matmul/vector": ran}:
                fail(f"{job}: its workers launched {in_workers}, expected "
                     f"{ran} matmuls on the simt route with vector loads")
            total += ran
            n_jobs += 1
            line("gateway_path", {
                "run": what, "tenant": tenant,
                "outputs_only": outputs_only, "workers": N_WORKERS,
                "client_wall_s": walls[tenant], "run_wall_s": together,
                # from the job's gather to its results in the client: the
                # frame's encode, its trip over localhost TCP, its decode
                "gather_to_client_s": walls[tenant]
                - stats["submit_to_gather_s"],
                **{k: stats[k] for k in (
                    "job_id", "n_clusters", "submit_to_first_dispatch_s",
                    "submit_to_gather_s", "result_bytes", "result_encode_s",
                    "result_decode_s", "recomputed", "tasks_run",
                    "kernel_launches")},
                "values_returned": len(got),
                "equals_sequential": True, "reduce": got[reduce_tid]})
            del got
        return futs, submitted

    try:
        # 1. cold: the pool's start-up is paid inside this job.  The
        # driver queues the first super-tasks on the workers' pipes before
        # they have booted, so the first dispatch comes at once; the first
        # completed super-task (as in phase 4b) is what shows the start-up
        futs, submitted = run("cold", {"cold": False})
        first_dispatch = (submitted["cold"] - t_start
                          + futs["cold"].stats["submit_to_first_dispatch_s"])
        del futs
        # 2. warm: two tenants at once, only the reduce comes back
        run("warm", {"a": True, "b": True})
        # 3. quota: a typed rejection, and nothing admitted
        admitted = gw.executor.stats["jobs_admitted"]
        err = client("thin").submit(graph).exception(PROCESS_TIMEOUT)
        if not (isinstance(err, QuotaExceeded)
                and err.resource == "store_bytes"
                and err.limit == values - 1):
            fail(f"quota: tenant 'thin' got {err!r}, expected QuotaExceeded "
                 f"on store_bytes with limit {values - 1}")
        thin = gw.stats()["thin"]
        if gw.executor.stats["jobs_admitted"] != admitted or \
                thin["submitted"] or thin["inflight_jobs"] or \
                thin["rejected"] != 1:
            fail(f"quota: a rejected job was admitted ({thin})")
        line("gateway_quota", {"tenant": "thin", "resource": err.resource,
                               "limit": err.limit,
                               "requested": err.requested,
                               "message": str(err)})

        # 4. a worker SIGKILLed while the victim's clusters run
        def kill_when_running(futs):
            base = gw.executor.stats["dispatched"]
            deadline = time.perf_counter() + PROCESS_TIMEOUT
            while gw.executor.stats["dispatched"] < base + N_WORKERS + 2:
                if time.perf_counter() > deadline or futs["victim"].done():
                    fail("SIGKILL run: the victim's clusters never ran")
                time.sleep(0.01)
            gw.executor.kill_worker(1)

        # the victim takes every value back, recomputed ones included
        failures = gw.executor.stats["failures"]
        run("sigkill", {"victim": False, "bystander": True},
            during=kill_when_running)
        pool = gw.stats()
        if gw.executor.stats["failures"] != failures + 1:
            fail(f"SIGKILL run: {gw.executor.stats['failures'] - failures} "
                 f"worker deaths, expected 1")
        if any(pool[t]["failed"] for t in pool if t != "pool"):
            fail(f"a tenant's job failed: {pool}")
        if driver.launches:
            fail(f"gateway path: this process launched {driver.launches} "
                 f"matmuls")
        line("gateway_pool", {
            "workers": N_WORKERS, "start_method": gw.executor.start_method,
            "first_dispatch_s": first_dispatch,
            # from start() to the first completed super-task: 4 spawned
            # interpreters, torch, CUDA contexts, the library, one gen pair
            "first_done_s": gw.executor.stats["first_done_s"],
            "transport_requested": transport,
            "transport_used": gw.executor.transport_used,
            "transport_note": None if room else
            f"/dev/shm cannot hold twice the values of two jobs "
            f"({2 * values} bytes), so the pool names transport='sock'",
            "dev_shm_bytes": shm_total, "dev_shm_free_bytes": shm_free,
            "jobs": n_jobs, "matmul_launches": total,
            **{k: gw.executor.stats[k] for k in (
                "jobs_admitted", "jobs_completed", "jobs_failed",
                "failures", "recomputed", "dispatched", "bytes_direct",
                "bytes_driver")},
            "tenants": {t: {k: v[k] for k in (
                "completed", "failed", "rejected")}
                for t, v in pool.items() if t != "pool"}})
    finally:
        for c in clients.values():
            c.close()
        gw.stop()
    torch.cuda.empty_cache()
    return total


def scan_bound(Bsz: int, S: int, D: int, N: int, itemsize: int,
               with_h0: bool):
    """Least time the card could take for one scan: x, dt, B, C (and h0)
    read once, y and h_final written once, A read once, at HBM bandwidth;
    or 7 float32 operations per state element and step (the exp counted
    as one) at the CUDA cores' float32 peak, whatever the input type."""
    nbytes = (itemsize * (3 * Bsz * S * D + 2 * Bsz * S * N) + 4 * D * N
              + 4 * Bsz * D * N * (2 if with_h0 else 1))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 7.0 * Bsz * S * D * N / PEAK_FLOPS["float32"] * 1e3
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms, "bytes")


def phase_scan_kernels(torch) -> list:
    import torch.nn.functional as F
    from repro_torch.kernels import ref, ssm_scan as scan
    from repro_torch.models.layers import ParamSpec, init_param
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    checks = []
    for Bsz, S, D, N, with_h0 in SCAN_SHAPES:
        # dt as the model makes it: softplus of a unit normal shifted by a
        # dt bias from the model's own initialiser; A from mamba_A
        dt_bias = init_param(ParamSpec("smoke/dt_bias", (D,), "mamba_dt"),
                             0, torch.float32, dev)
        A = -torch.exp(init_param(ParamSpec("smoke/A_log", (D, N),
                                            "mamba_A"), 0, torch.float32,
                                  dev))
        x = torch.randn(Bsz, S, D, generator=gen, device=dev)
        dt = F.softplus(torch.randn(Bsz, S, D, generator=gen, device=dev)
                        + dt_bias)
        B = torch.randn(Bsz, S, N, generator=gen, device=dev)
        C = torch.randn(Bsz, S, N, generator=gen, device=dev)
        h0 = (torch.randn(Bsz, D, N, generator=gen, device=dev)
              if with_h0 else None)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            args = [t.to(dtype) for t in (x, dt, B, C)] + [A, h0]
            y, h = scan.ssm_scan(*args, return_state=True)
            want_y, want_h = ref.ssm_scan(*args, return_state=True)
            torch.cuda.synchronize()
            tol = SCAN_TOL[dname]
            err_y = (y.float() - want_y.float()).abs().max().item()
            err_h = (h - want_h).abs().max().item()
            ok = (y.dtype == dtype and h.dtype == torch.float32
                  and torch.allclose(y.float(), want_y.float(), rtol=tol,
                                     atol=tol)
                  and torch.allclose(h, want_h, rtol=tol, atol=tol))
            if not ok:
                fail(f"ssm_scan {dname} {(Bsz, S, D, N)} h0={with_h0}: "
                     f"kernel disagrees with the plain version, max |err| "
                     f"y {err_y}, h_final {err_h}")
            b_ms, b_by = scan_bound(Bsz, S, D, N, dtype.itemsize, with_h0)
            checks.append({
                "shape": [Bsz, S, D, N], "h0": with_h0, "dtype": dname,
                "max_abs_err": max(err_y, err_h), "max_abs_err_y": err_y,
                "max_abs_err_h": err_h, "tol": tol,
                "ms": cuda_ms(torch, lambda: scan.ssm_scan(
                    *args, return_state=True)),
                "plain_ms": cuda_ms(torch, lambda: ref.ssm_scan(
                    *args, return_state=True), reps=2 if S > 64 else REPS),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
            print(f"ssm_scan {dname} {Bsz}x{S}x{D} N={N} h0={with_h0}: "
                  f"err {checks[-1]['max_abs_err']:.3g} (tol {tol}) | "
                  f"kernel {checks[-1]['ms']:.4f} ms | plain "
                  f"{checks[-1]['plain_ms']:.3f} ms | bound {b_ms:.4f} ms "
                  f"({b_by})", flush=True)
            del args, y, h, want_y, want_h
    line("ssm_scan_vs_plain", checks)
    return checks


def flash_bound(B: int, H: int, KH: int, Sq: int, Sk: int, D: int,
                causal: bool, dtype: str, itemsize: int):
    """Least time the card could take for one attention: 4 * D operations
    (the two products) per visible (query, key) pair at the input type's
    peak, or q, k, v read once and the output written once at HBM
    bandwidth.  Under the top-left causal mask query i sees min(i + 1, Sk)
    keys."""
    if causal:
        n = min(Sq, Sk)
        pairs = n * (n + 1) // 2 + max(Sq - Sk, 0) * Sk
    else:
        pairs = Sq * Sk
    ops_ms = 4.0 * D * pairs * B * H / PEAK_FLOPS[dtype] * 1e3
    nbytes = itemsize * (2 * B * H * Sq * D + 2 * B * KH * Sk * D)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _misaligned(torch, t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary, which
    the wgmma route cannot take: a bf16 call with it runs the simt kernel."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def phase_flash_kernels(torch) -> list:
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    for B, H, KH, Sq, Sk, D, causal in FLASH_SHAPES:
        q = torch.randn(B, H, Sq, D, generator=gen, device="cuda")
        k = torch.randn(B, KH, Sk, D, generator=gen, device="cuda")
        v = torch.randn(B, KH, Sk, D, generator=gen, device="cuda")
        # float32 (simt), bf16 (wgmma at these head dims) and bf16 through
        # the simt kernel (misaligned copies)
        for dtype, aligned in ((torch.float32, True), (torch.bfloat16, True),
                               (torch.bfloat16, False)):
            dname = str(dtype).removeprefix("torch.")
            args = [t.to(dtype) for t in (q, k, v)]
            if not aligned:
                args = [_misaligned(torch, t) for t in args]
            path = fa.route(dtype, D, aligned=aligned)
            what = (f"flash_attention {dname} {(B, H, KH, Sq, Sk, D)} "
                    f"causal={causal} ({path})")
            before = fa.flash_attention.route_launches[path]
            got = fa.flash_attention(*args, causal=causal)
            want = ref.attention(*args, causal=causal)
            again = fa.flash_attention(*args, causal=causal)
            torch.cuda.synchronize()
            if fa.flash_attention.route_launches[path] != before + 2:
                fail(f"{what}: no launch on the {path} route")
            tol = TOL[dname]
            err = (got.float() - want.float()).abs().max().item()
            if got.dtype != dtype or not torch.allclose(
                    got.float(), want.float(), rtol=tol, atol=tol):
                fail(f"{what}: kernel disagrees with the plain version, "
                     f"max |err| {err}")
            if not torch.equal(got.view(torch.uint8), again.view(torch.uint8)):
                fail(f"{what}: two launches gave different bits")

            def library():
                return F.scaled_dot_product_attention(
                    *args, is_causal=causal, enable_gqa=True)
            # the library call against the same plain version, so the
            # kernel's error can be read beside one it does not make
            lib_err = (library().float() - want.float()).abs().max().item()
            b_ms, b_by = flash_bound(B, H, KH, Sq, Sk, D, causal, dname,
                                     dtype.itemsize)
            checks.append({
                "shape": [B, H, KH, Sq, Sk, D], "causal": causal,
                "dtype": dname, "route": path, "aligned": aligned,
                "max_abs_err": err, "tol": tol,
                "same_bits": True, "library_max_abs_err": lib_err,
                "ms": cuda_ms(torch, lambda: fa.flash_attention(
                    *args, causal=causal)),
                "plain_ms": cuda_ms(torch, lambda: ref.attention(
                    *args, causal=causal)),
                "library_ms": cuda_ms(torch, library),
                "bound_ms": b_ms, "bound_by": b_by})
            c = checks[-1]
            print(f"flash_attention {dname} {B}x{H}x{Sq}x{D} kv {KH}x{Sk} "
                  f"causal={causal} ({path}{', misaligned' if not aligned else ''}"
                  f"): err {err:.3g} (tol {tol}) | kernel {c['ms']:.4f} ms | plain "
                  f"{c['plain_ms']:.4f} ms | sdpa {c['library_ms']:.4f} ms | "
                  f"bound {b_ms:.4f} ms ({b_by})", flush=True)
            del args, got, want, again
    line("flash_attention_vs_plain", checks)
    return checks


def phase_params(torch, arch: str, n_params: int):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    cfg = get_config(arch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = TF.init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    leaves, stack = [], [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            leaves.append(node)
    n = sum(t.numel() for t in leaves)
    if n != n_params or n != TF.count_params(cfg):
        fail(f"{arch}: drew {n} parameters, expected {n_params}")
    if not all(t.is_cuda and t.dtype == cfg.pdtype for t in leaves):
        fail(f"{arch}: parameters not all {cfg.pdtype} on the card")
    line("params", {"arch": arch, "n_params": n, "dtype": cfg.param_dtype,
                    "bytes": sum(t.numel() * t.element_size()
                                 for t in leaves),
                    "draw_s": seconds, "layers": cfg.n_layers,
                    "d_model": cfg.d_model, "vocab": cfg.vocab_size,
                    "compute_dtype": cfg.compute_dtype,
                    **({"d_inner": cfg.d_inner, "state": cfg.ssm_state}
                       if _path_kernel(cfg) == "ssm_scan" else
                       {"heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                        "head_dim": cfg.head_dim, "d_ff": cfg.d_ff})})
    return cfg, params


def _counters():
    from repro_torch.kernels import flash_attention as fa, matmul as mm
    from repro_torch.kernels import ssm_scan as scan
    return {"matmul": mm.matmul, "ssm_scan": scan.ssm_scan,
            "flash_attention": fa.flash_attention}


def _reset(fn) -> None:
    """Sets a kernel wrapper's launch counts, and its counts by route and
    load variant, to 0."""
    fn.launches = 0
    for by in ("route_launches", "variant_launches"):
        if hasattr(fn, by):
            setattr(fn, by, dict.fromkeys(getattr(fn, by), 0))


# the port's kernels among a profile's device entries
PORT_KERNEL = re.compile(r"\b(matmul|matmul_wgmma|ssm_scan|flash_attention|"
                         r"flash_wgmma)_kernel\b")

def expected_route(cfg):
    """The route every launch of a model path's kernel must take, or None
    for a kernel of one route (the scan): for flash attention, what
    ``kernels/flash_attention.py::route`` gives for the path's compute dtype
    and head dim with aligned tensors (qwen2-7b: ``wgmma`` in bf16, ``simt``
    in float32)."""
    if _path_kernel(cfg) != "flash_attention":
        return None
    from repro_torch.kernels import flash_attention as fa
    return fa.route(cfg.cdtype, cfg.head_dim)


def _check_routes(fn, cfg, what: str) -> dict:
    """A path kernel's launches by route; fails if one left its route."""
    routes = getattr(fn, "route_launches", None)
    want = expected_route(cfg)
    if want and routes != {r: (fn.launches if r == want else 0)
                           for r in routes}:
        fail(f"{what}: {fn.__name__} launches by route {routes}, expected "
             f"all {fn.launches} on {want}")
    return routes


def _launch_routes(fn, in_workers=None) -> collections.Counter:
    """A path kernel's launches since its last ``_reset``, by route, plus
    those in a workers' report (``kernel_launches``) when one is given; a
    kernel of one route (the scan, on the CUDA cores) counts as ``simt``."""
    name, routes = fn.__name__, getattr(fn, "route_launches", None)
    counts = collections.Counter(routes if routes is not None
                                 else {"simt": fn.launches})
    if in_workers is not None:
        for r in (routes or {"simt": 0}):
            counts[r] += in_workers.get(f"{name}/{r}" if routes else name, 0)
    return counts


def _path_kernel(cfg) -> str:
    """The kernel a model's path launches: the scan for Mamba1 (every
    forward), flash attention for the dense transformer (every prefill)."""
    return "ssm_scan" if cfg.layer_plan[0] == "mamba1" else "flash_attention"


def phase_serve(torch, cfg, params) -> int:
    from repro_torch.launch import serve
    counters = _counters()
    kernel = _path_kernel(cfg)
    argv = ["--arch", cfg.name] + SERVE_ARGS
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        _reset(fn)
    out = serve.main(argv, params=params)
    launches = {name: fn.launches for name, fn in counters.items()}
    routes = _check_routes(counters[kernel], cfg, f"{cfg.name} serve")
    finished = sorted(out["finished"], key=lambda r: r.rid)
    if len(finished) != 4 or out["decode_steps"] != SERVE_DECODE_STEPS:
        fail(f"served {len(finished)} requests in {out['decode_steps']} "
             f"decode steps, expected 4 in {SERVE_DECODE_STEPS}")
    if out["forwards"] != SERVE_FORWARDS or \
            out["prefills"] != SERVE_PREFILLS:
        fail(f"{out['forwards']} forwards and {out['prefills']} prefills, "
             f"expected {SERVE_FORWARDS} and {SERVE_PREFILLS}")
    # the scan runs in every forward, flash attention in every prefill
    per = out["forwards"] if kernel == "ssm_scan" else out["prefills"]
    want = {name: 0 for name in counters}
    want[kernel] = cfg.n_layers * per
    if launches != want:
        fail(f"{cfg.name}: kernel launches {launches}, expected {want}")
    if out["traced_tokens"] != finished[0].out[:3]:
        fail(f"traced tokens {out['traced_tokens']} do not prefix request "
             f"0's {finished[0].out}")
    if any(not 0 <= t < cfg.vocab_size for r in finished for t in r.out):
        fail("a served token lies outside the vocabulary")
    line("serve", {
        "arch": cfg.name, "argv": argv, "requests": len(finished),
        "decode_steps": out["decode_steps"], "forwards": out["forwards"],
        "prefills": out["prefills"], "launches": launches,
        "launches_by_route": routes, "wall_s": out["wall"],
        "ttft_p50_s": out["ttft_p50"], "latency_p50_s": out["latency_p50"],
        "decode_tok_s": out["decode_tok_s"],
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "traced_tokens": out["traced_tokens"],
        "tokens": {r.rid: r.out for r in finished}})
    return _launch_routes(counters[kernel]), out["traced_tokens"]


def phase_serve_process(torch, arch: str, reduced: bool) -> int:
    """Phases 6b and 9b: the serve launcher with its traced request on
    cluster worker processes (``--backend process``).  They spawn, since
    this process has initialised CUDA, and each draws its own parameter set
    from the seed, so the phase runs after the full-width parameters are
    freed.  Reduced, on two workers; then at full width on one worker, so
    that this process and the worker hold two parameter sets (2 x 29 GB or
    2 x 30.5 GB) on the 80 GB card, where two workers would need three.

    The workers report their kernel launches with each ``done``; the
    traced request's 3 forwards (1 prefill) must have launched the path's
    kernel ``n_layers`` times each in them, and the main loop's the rest in
    this process.  Returns the path kernel's launches in both."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    kernel = _path_kernel(cfg)
    counters = _counters()
    workers = 2 if reduced else 1
    argv = (["--arch", arch] + (["--reduced"] if reduced else [])
            + PROCESS_SERVE_ARGS + ["--graph-workers", str(workers)])
    what = f"{arch}{' --reduced' if reduced else ''} --backend process"
    for fn in counters.values():
        _reset(fn)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = serve.main(argv)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    finished = sorted(out["finished"], key=lambda r: r.rid)
    if len(finished) != 4:
        fail(f"{what}: served {len(finished)} requests")
    traced = out["traced_tokens"]
    if traced is None or len(traced) != 3 or traced != finished[0].out[:3]:
        fail(f"{what}: traced tokens {traced} do not prefix request 0's "
             f"{finished[0].out}")
    # this process ran the main loop; the traced request's 3 forwards (1
    # prefill) ran in the workers
    per = (out["forwards"] - 3 if kernel == "ssm_scan"
           else out["prefills"] - 1)
    want = {name: 0 for name in counters}
    want[kernel] = cfg.n_layers * per
    if launches != want:
        fail(f"{what}: kernel launches in this process {launches}, "
             f"expected {want}")
    stats = out["graph_stats"]
    ran = {k: stats["tasks_run"].get(k, 0) for k in ("prefill", "decode")}
    if ran != {"prefill": 1, "decode": 2}:
        fail(f"{what}: the workers ran {ran}, expected 1 prefill and 2 "
             f"decodes")
    in_workers = stats["kernel_launches"]
    n = cfg.n_layers * (3 if kernel == "ssm_scan" else 1)
    if {k: v for k, v in in_workers.items() if "/" not in k} != {kernel: n}:
        fail(f"{what}: the workers launched {in_workers}, expected {n} "
             f"{kernel} launches")
    route = expected_route(cfg)
    if route and in_workers.get(f"{kernel}/{route}") != n:
        fail(f"{what}: the workers' {kernel} launches by route "
             f"{in_workers}, expected all {n} on {route}")
    line("serve_process", {
        "arch": arch, "argv": argv, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "graph_workers": workers, "wall_s": wall,
        "driver_launches": launches, "worker_launches": in_workers,
        "worker_tasks_run": stats["tasks_run"],
        "graph_first_done_s": stats["first_done_s"],
        "graph_last_done_s": stats["last_done_s"],
        "driver_peak_device_bytes": torch.cuda.max_memory_allocated(),
        "traced_tokens": traced,
        "tokens": {r.rid: r.out for r in finished}})
    del out
    return _launch_routes(counters[kernel], in_workers)


def phase_serve_gateway(torch, arch: str, thread_tokens: list) -> int:
    """Phases 6c and 9c: the serve launcher at full width with its traced
    request sent to a 1-worker gateway (``--gateway``), whose spawned
    worker draws its own parameter set from the seed.  One model a pool:
    the worker keeps what it drew until the pool stops, and two models'
    parameters there (29 + 30.5 GB) beside this process's own set would not
    fit the card.  The traced tokens must be a prefix of request 0's and
    equal the thread backend's (``thread_tokens``, phase 6 or 9); the job's
    worker must report the path kernel ``n_layers`` times a forward (scan)
    or a prefill (flash, all on wgmma), and this process the main loop's.
    Returns the path kernel's launches in both."""
    from repro_torch.config import ClusterConfig
    from repro_torch.configs import get_config
    from repro_torch.gateway import GatewayService
    from repro_torch.launch import serve
    cfg = get_config(arch)
    kernel = _path_kernel(cfg)
    counters = _counters()
    token = secrets.token_hex(16)
    what = f"{arch} --gateway"
    for fn in counters.values():
        _reset(fn)
    torch.cuda.reset_peak_memory_stats()
    gw = GatewayService(ClusterConfig(
        n_workers=1, start_method="spawn", token=token,
        progress_timeout=PROCESS_TIMEOUT))
    t0 = time.perf_counter()
    gw.start()
    try:
        argv = (["--arch", arch] + GATEWAY_SERVE_ARGS
                + ["--gateway", gw.address, "--gateway-token", token,
                   "--tenant", "serve"])
        out = serve.main(argv)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        pool = gw.stats()
        start_method = gw.executor.start_method
    finally:
        gw.stop()
    launches = {name: fn.launches for name, fn in counters.items()}
    finished = sorted(out["finished"], key=lambda r: r.rid)
    traced = out["traced_tokens"]
    if len(finished) != 4:
        fail(f"{what}: served {len(finished)} requests")
    if traced != finished[0].out[:3] or traced != thread_tokens:
        fail(f"{what}: traced tokens {traced}, request 0's {finished[0].out}"
             f", the thread backend's {thread_tokens}")
    per = (out["forwards"] - 3 if kernel == "ssm_scan"
           else out["prefills"] - 1)
    want = {name: 0 for name in counters}
    want[kernel] = cfg.n_layers * per
    if launches != want:
        fail(f"{what}: kernel launches in this process {launches}, "
             f"expected {want}")
    stats = out["graph_stats"]
    ran = {k: stats["tasks_run"].get(k, 0) for k in ("prefill", "decode")}
    if ran != {"prefill": 1, "decode": 2} or stats["tenant"] != "serve":
        fail(f"{what}: the job ran {ran} as {stats['tenant']!r}, expected 1 "
             f"prefill and 2 decodes as 'serve'")
    in_workers = stats["kernel_launches"]
    n = cfg.n_layers * (3 if kernel == "ssm_scan" else 1)
    if {k: v for k, v in in_workers.items() if "/" not in k} != {kernel: n}:
        fail(f"{what}: the worker launched {in_workers}, expected {n} "
             f"{kernel} launches")
    route = expected_route(cfg)
    if route and in_workers.get(f"{kernel}/{route}") != n:
        fail(f"{what}: the worker's {kernel} launches by route "
             f"{in_workers}, expected all {n} on {route}")
    if pool["serve"]["failed"] or pool["serve"]["completed"] != 1:
        fail(f"{what}: tenant accounting {pool['serve']}")
    line("serve_gateway", {
        "arch": arch, "argv": [a if a != token else "<token>" for a in argv],
        "layers": cfg.n_layers, "d_model": cfg.d_model, "pool_workers": 1,
        "start_method": start_method, "wall_s": wall,
        "job_wall_s": stats["submit_to_gather_s"],
        "submit_to_first_dispatch_s": stats["submit_to_first_dispatch_s"],
        "result_bytes": stats["result_bytes"],
        "driver_launches": launches, "worker_launches": in_workers,
        "worker_tasks_run": stats["tasks_run"],
        "driver_peak_device_bytes": peak, "traced_tokens": traced,
        "tokens": {r.rid: r.out for r in finished}})
    del out
    return _launch_routes(counters[kernel], in_workers)


def phase_long_prefill(torch, cfg, params) -> dict:
    """One LONG_PROMPT prefill and LONG_DECODE greedy steps in ``cfg``'s
    compute dtype, with the path kernel and with its plain version; the
    kernel run's prefill also times the kernel's own launches (CUDA events
    around each)."""
    from repro_torch.models import transformer as TF
    counter = _counters()[_path_kernel(cfg)]
    module = sys.modules[counter.__module__]
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(1, cfg.vocab_size, (1, LONG_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)

    def run(impl, feed=None):
        """Prefill, then LONG_DECODE greedy steps fed the run's own tokens
        or ``feed``'s; returns tokens, last-position logits, seconds, and
        the path kernel's device ms within the prefill."""
        prefill = TF.make_prefill_step(cfg, LONG_MAX_LEN, impl=impl)
        decode = TF.make_decode_step(cfg, impl=impl)
        torch.cuda.synchronize()
        with (timed_launches(torch, module, counter.__name__)
              if impl == "kernel" else contextlib.nullcontext([])) as events:
            t0 = time.perf_counter()
            last, cache = prefill(params, prompt)
            logits = [last[0].clone()]
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        kernel_ms = events_ms(torch, events)
        for i in range(LONG_DECODE):
            tok = feed[i] if feed else int(torch.argmax(logits[-1]))
            step, cache = decode(params, cache, torch.tensor(
                [[tok]], dtype=torch.int32, device="cuda"))
            logits.append(step[0].clone())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0 - prefill_s
        logits = torch.stack(logits)
        toks = [int(t) for t in torch.argmax(logits, dim=-1)]
        return toks, logits, prefill_s, decode_s, kernel_ms

    torch.cuda.reset_peak_memory_stats()
    _reset(counter)
    toks_k, logits_k, pre_k, dec_k, kernel_ms = run("kernel")
    launches_k = counter.launches
    routes = _check_routes(counter, cfg,
                           f"{cfg.name} {cfg.compute_dtype} long prefill")
    peak = torch.cuda.max_memory_allocated()
    toks_r, logits_r, pre_r, dec_r, _ = run("ref", feed=toks_k)
    # the scan runs in every forward, flash attention in the prefill
    want = cfg.n_layers * (1 + LONG_DECODE if counter.__name__ == "ssm_scan"
                           else 1)
    if launches_k != want or counter.launches != launches_k:
        fail(f"{launches_k} and {counter.launches - launches_k} "
             f"{counter.__name__} launches in the kernel and plain runs, "
             f"expected {want} and 0")
    if not (torch.isfinite(logits_k).all() and torch.isfinite(logits_r).all()):
        fail("non-finite logits in the long prefill")
    diff = (logits_k - logits_r).abs().max().item()
    if diff > LOGIT_TOL:
        fail(f"long prefill: kernel and plain versions give last-position "
             f"logits {diff} apart, tolerance {LOGIT_TOL}")
    for j, (a, b) in enumerate(zip(toks_k, toks_r)):
        top2 = logits_r[j].topk(2).values
        if a != b and (top2[0] - top2[1]).item() > LOGIT_TOL:
            fail(f"long prefill: greedy token {j} differs ({a} vs {b}) and "
                 f"the plain run's top two logits are "
                 f"{(top2[0] - top2[1]).item()} apart")
    out = {"arch": cfg.name, "compute_dtype": cfg.compute_dtype,
           "prompt_tokens": LONG_PROMPT, "decode_steps": LONG_DECODE,
           "max_abs_logit_diff": diff, "tol": LOGIT_TOL,
           "logit_std": logits_r.std().item(),
           "logit_max_abs": logits_r.abs().max().item(),
           "tokens_kernel": toks_k, "tokens_plain": toks_r,
           "prefill_s_kernel": pre_k, "decode_ms_per_step_kernel":
           dec_k / LONG_DECODE * 1e3, "prefill_s_plain": pre_r,
           "decode_ms_per_step_plain": dec_r / LONG_DECODE * 1e3,
           f"{counter.__name__}_launches": launches_k,
           "launches_by_route": routes,
           f"{counter.__name__}_prefill_ms": kernel_ms,
           f"{counter.__name__}_prefill_share": kernel_ms / 1e3 / pre_k,
           "peak_device_bytes": peak}
    line("long_prefill", out)
    out["routes"] = _launch_routes(counter)
    return out


def phase_profile(torch, cfg, params) -> None:
    """Where a serve path's device time goes (``--profile`` only): one
    decode step, one served-size prefill and one LONG_PROMPT prefill under
    ``torch.profiler``, with the device time of each kernel name and the
    device's busy share of the host-clock wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as TF
    prefill = TF.make_prefill_step(cfg, SERVE_MAX_LEN)
    prefill_long = TF.make_prefill_step(cfg, LONG_MAX_LEN)
    decode = TF.make_decode_step(cfg)
    prompt = torch.randint(1, cfg.vocab_size, (1, LONG_PROMPT),
                           device="cuda", dtype=torch.int32)
    short = prompt[:, :12].contiguous()
    token = torch.ones((1, 1), dtype=torch.int32, device="cuda")
    cache = prefill(params, short)[1]
    for name, fn in (("decode_step", lambda: decode(params, cache, token)),
                     ("prefill_12", lambda: prefill(params, short)),
                     (f"prefill_{LONG_PROMPT}",
                      lambda: prefill_long(params, prompt))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the device's own entries (kernels, copies, sets): their self
        # device times add up to the time the device was busy
        kernels = [(e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0]
        kernels.sort(reverse=True)
        busy_us = sum(k[0] for k in kernels)
        line(f"profile_{cfg.name}_{name}", {
            "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / wall,
            "kernel_launches": sum(k[1] for k in kernels),
            "top": [{"kernel": k[2][:120], "count": k[1],
                     "device_ms": k[0] / 1e3} for k in kernels[:12]],
            # the port's own kernels, wherever they rank
            "port_kernels": [{"kernel": k[2][:120], "count": k[1],
                              "device_ms": k[0] / 1e3} for k in kernels
                             if PORT_KERNEL.search(k[2])]})


def phase_model(torch, arch: str, n_params: int, profile: bool):
    """Draw ``arch`` on the card, serve it, run the long prefill (for the
    dense model in its bf16 compute and again in float32 on the same
    parameters; with ``profile``, profile it), free its parameters, then
    serve it on the process backend, reduced and at full width, and through
    a gateway; returns the path kernel's launches in all of those runs, by
    route."""
    import gc
    cfg, params = phase_params(torch, arch, n_params)
    launches, thread_tokens = phase_serve(torch, cfg, params)
    launches += phase_long_prefill(torch, cfg, params)["routes"]
    if _path_kernel(cfg) == "flash_attention":
        # the float32 route at full width: the same parameters computed in
        # float32 (they are float32 already, so nothing is copied)
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        launches += phase_long_prefill(torch, f32, params)["routes"]
    if profile:
        phase_profile(torch, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    line("freed", {"arch": arch,
                   "allocated_bytes": torch.cuda.memory_allocated()})
    for reduced in (True, False):
        launches += phase_serve_process(torch, arch, reduced)
    gc.collect()
    torch.cuda.empty_cache()
    launches += phase_serve_gateway(torch, arch, thread_tokens)
    gc.collect()
    torch.cuda.empty_cache()
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
    launches, graph, seq = phase_main_path(torch, checks)
    launches += phase_process_path(torch, graph, seq)
    launches += phase_gateway_path(torch, graph, seq)
    del seq
    torch.cuda.empty_cache()
    scan_checks = phase_scan_kernels(torch)
    profile = "--profile" in sys.argv[1:]
    # the two parameter sets (29 GB and 30.5 GB) are on the card one at a
    # time
    scan_launches = phase_model(torch, ARCH, N_PARAMS, profile)
    flash_checks = phase_flash_kernels(torch)
    flash_launches = phase_model(torch, DENSE_ARCH, DENSE_N_PARAMS, profile)

    def entry(kernel, source, replaces, launches, routes, check, all_checks):
        return {"name": kernel, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "launches_by_route": dict(routes),
                "kernel_route": check.get("route", "simt"),
                **({"kernel_variant": check["variant"]}
                   if "variant" in check else {}),
                "max_abs_err": check["max_abs_err"], "ms": check["ms"],
                "plain_ms": check["plain_ms"], "bound_ms": check["bound_ms"],
                "bound_by": check["bound_by"],
                "library_ms": check["library_ms"], "shape": check["shape"],
                "dtype": check["dtype"], "checks": all_checks}

    main_check = next(c for c in checks
                      if c["dtype"] == "float32" and c["shape"] == [SIZE] * 3)
    # the Mamba1 path's most launched shape: one decode step from the cache
    decode_check = next(c for c in scan_checks
                        if c["dtype"] == "float32" and c["shape"][1] == 1)
    # the dense path's longest launches: the long prefill in bf16 (tensor
    # cores) and in float32 (CUDA cores)
    long_checks = {c["route"]: c for c in flash_checks
                   if c["shape"][3] == LONG_PROMPT and c["aligned"]}
    # flash_attention: the wrapper's launches on both routes, headed by the
    # tensor-core kernel of the bf16 long prefill, as in earlier runs;
    # flash_attention_simt: the CUDA-core kernel and its own launches
    flash = "src/repro/kernels/flash_attention.py:76"
    kernels = [
        entry("matmul", "matmul.cu", "src/repro/kernels/matmul_pallas.py:45",
              launches, {"simt": launches}, main_check, checks),
        entry("ssm_scan", "ssm_scan.cu", "src/repro/kernels/ssm_scan.py:48",
              scan_launches["simt"], scan_launches, decode_check,
              scan_checks),
        entry("flash_attention", "flash_attention_wgmma.cu", flash,
              sum(flash_launches.values()), flash_launches,
              long_checks["wgmma"], flash_checks),
        entry("flash_attention_simt", "flash_attention.cu", flash,
              flash_launches["simt"], {"simt": flash_launches["simt"]},
              long_checks["simt"], flash_checks)]
    if not all(k["launches"] for k in kernels):
        fail(f"a kernel of the main path never launched: "
             f"{[(k['name'], k['launches']) for k in kernels]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

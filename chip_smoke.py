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
5. ssm_scan — the selective-scan kernel against its plain version at the
   long-prefill shape (1x2048x8192, N = 16), a decode step (S = 1, with
   ``h0``) and a ragged shape (3x1000x1000, with ``h0``), in float32 and
   bfloat16, with CUDA-event times beside the card's bound;
6. serve — falcon-mamba-7b at full width (64 layers, 7,272,665,088
   float32 parameters drawn on the card from a seed) served by the port's
   launcher, ``repro_torch.launch.serve.main``, with a traced request on
   the threaded executor: 4 requests, 28 decode steps, the traced tokens a
   prefix of request 0's, and 64 scan launches per forward;
7. long prefill — one 2048-token prompt through the prefill step and 8
   greedy decode steps, once with the scan kernel and once with its plain
   version on the same tokens: last-position logits within ``LOGIT_TOL``;
8. flash_attention — the flash-attention kernel against its plain version
   at qwen2-7b's long prefill (q 1x28x2048x128, k, v 1x4x2048x128,
   causal), a served prefill (S = 12), a ragged shape (2x8x1000x64, 2 kv
   heads), a cross-shaped one (Sq 300, Sk 777, not causal) and one with
   D = 72, in float32 and bfloat16, with CUDA-event times of the kernel, the
   plain version and ``scaled_dot_product_attention`` beside the card's
   bound, and the route of each check;
9. serve — falcon-mamba-7b's parameters freed, qwen2-7b at full width
   (28 layers, 7,615,616,512 float32 parameters drawn on the card from a
   seed) served by the same launcher and argv: 28 decode steps, the traced
   tokens a prefix of request 0's, 28 flash launches per prefill, all on
   the wgmma route, and none per decode step;
10. long prefill — phase 7 for qwen2-7b, with the flash kernel and with its
   plain version: 28 launches in the kernel run, all on the wgmma route,
   none in the plain one.

With ``--profile`` it also profiles one decode step and two prefills of
each served model (device time by kernel, device busy share, and the
device time of the port's own kernels).

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
# (M, N, K): the main shape, a ragged one (bf16 keeps the CUDA cores: its
# rows are not 16-byte aligned) and an aligned one that no tile divides
KERNEL_SHAPES = [(SIZE, SIZE, SIZE), (1000, 1531, 777), (1000, 1528, 776)]
REPS = 10

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
# prefill, a ragged shape, a cross-shaped one and one whose D is a multiple
# of 8 but not of 16
FLASH_SHAPES = [(1, 28, 4, 2048, 2048, 128, True),
                (1, 28, 4, 12, 12, 128, True),
                (2, 8, 2, 1000, 1000, 64, True),
                (1, 8, 2, 300, 777, 128, False),
                (1, 4, 2, 200, 333, 72, True)]
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


def phase_main_path(torch, checks: list) -> int:
    import numpy as np
    from repro_torch.interop import tensor_from_numpy
    from repro_torch.kernels import matmul as mm, ref
    from repro_torch.workloads import run_matrix_dag

    def bits(t):
        return t.view(torch.int32 if t.element_size() == 4 else torch.int16)

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


def phase_flash_kernels(torch) -> list:
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    for B, H, KH, Sq, Sk, D, causal in FLASH_SHAPES:
        q = torch.randn(B, H, Sq, D, generator=gen, device="cuda")
        k = torch.randn(B, KH, Sk, D, generator=gen, device="cuda")
        v = torch.randn(B, KH, Sk, D, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            args = [t.to(dtype) for t in (q, k, v)]
            path = fa.route(dtype, D)
            before = fa.flash_attention.route_launches[path]
            got = fa.flash_attention(*args, causal=causal)
            want = ref.attention(*args, causal=causal)
            torch.cuda.synchronize()
            if fa.flash_attention.route_launches[path] != before + 1:
                fail(f"flash_attention {dname} {(B, H, KH, Sq, Sk, D)}: no "
                     f"launch on the {path} route")
            tol = TOL[dname]
            err = (got.float() - want.float()).abs().max().item()
            if got.dtype != dtype or not torch.allclose(
                    got.float(), want.float(), rtol=tol, atol=tol):
                fail(f"flash_attention {dname} {(B, H, KH, Sq, Sk, D)} "
                     f"causal={causal} ({path}): kernel disagrees with the "
                     f"plain version, max |err| {err}")

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
                "dtype": dname, "route": path, "max_abs_err": err,
                "tol": tol,
                "library_max_abs_err": lib_err,
                "ms": cuda_ms(torch, lambda: fa.flash_attention(
                    *args, causal=causal)),
                "plain_ms": cuda_ms(torch, lambda: ref.attention(
                    *args, causal=causal)),
                "library_ms": cuda_ms(torch, library),
                "bound_ms": b_ms, "bound_by": b_by})
            c = checks[-1]
            print(f"flash_attention {dname} {B}x{H}x{Sq}x{D} kv {KH}x{Sk} "
                  f"causal={causal} ({path}): err {err:.3g} (tol {tol}) | kernel "
                  f"{c['ms']:.4f} ms | plain {c['plain_ms']:.4f} ms | sdpa "
                  f"{c['library_ms']:.4f} ms | bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
            del args, got, want
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
    """Sets a kernel wrapper's launch counts, and its counts by route, to 0."""
    fn.launches = 0
    if hasattr(fn, "route_launches"):
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)


# the port's kernels among a profile's device entries
PORT_KERNEL = re.compile(r"\b(matmul|matmul_wgmma|ssm_scan|flash_attention|"
                         r"flash_wgmma)_kernel\b")

# the route that every launch of a path's kernel must take: qwen2-7b's bf16
# attention at D = 128 runs on the tensor cores
PATH_ROUTE = {"flash_attention": "wgmma"}


def _check_routes(fn, what: str) -> dict:
    """A path kernel's launches by route; fails if one left its route."""
    routes = getattr(fn, "route_launches", None)
    want = PATH_ROUTE.get(fn.__name__)
    if want and routes != {r: (fn.launches if r == want else 0)
                           for r in routes}:
        fail(f"{what}: {fn.__name__} launches by route {routes}, expected "
             f"all {fn.launches} on {want}")
    return routes


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
    routes = _check_routes(counters[kernel], f"{cfg.name} serve")
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
    return launches[kernel]


def phase_long_prefill(torch, cfg, params) -> dict:
    from repro_torch.models import transformer as TF
    counter = _counters()[_path_kernel(cfg)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(1, cfg.vocab_size, (1, LONG_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)

    def run(impl, feed=None):
        """Prefill, then LONG_DECODE greedy steps fed the run's own tokens
        or ``feed``'s; returns tokens, last-position logits, seconds."""
        prefill = TF.make_prefill_step(cfg, LONG_MAX_LEN, impl=impl)
        decode = TF.make_decode_step(cfg, impl=impl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = prefill(params, prompt)
        logits = [last[0].clone()]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        for i in range(LONG_DECODE):
            tok = feed[i] if feed else int(torch.argmax(logits[-1]))
            step, cache = decode(params, cache, torch.tensor(
                [[tok]], dtype=torch.int32, device="cuda"))
            logits.append(step[0].clone())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0 - prefill_s
        logits = torch.stack(logits)
        toks = [int(t) for t in torch.argmax(logits, dim=-1)]
        return toks, logits, prefill_s, decode_s

    torch.cuda.reset_peak_memory_stats()
    _reset(counter)
    toks_k, logits_k, pre_k, dec_k = run("kernel")
    launches_k = counter.launches
    routes = _check_routes(counter, f"{cfg.name} long prefill")
    peak = torch.cuda.max_memory_allocated()
    toks_r, logits_r, pre_r, dec_r = run("ref", feed=toks_k)
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
    out = {"arch": cfg.name, "prompt_tokens": LONG_PROMPT,
           "decode_steps": LONG_DECODE,
           "max_abs_logit_diff": diff, "tol": LOGIT_TOL,
           "logit_std": logits_r.std().item(),
           "logit_max_abs": logits_r.abs().max().item(),
           "tokens_kernel": toks_k, "tokens_plain": toks_r,
           "prefill_s_kernel": pre_k, "decode_ms_per_step_kernel":
           dec_k / LONG_DECODE * 1e3, "prefill_s_plain": pre_r,
           "decode_ms_per_step_plain": dec_r / LONG_DECODE * 1e3,
           f"{counter.__name__}_launches": launches_k,
           "launches_by_route": routes, "peak_device_bytes": peak}
    line("long_prefill", out)
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
    """Draw ``arch`` on the card, serve it, run the long prefill (and, with
    ``profile``, profile it), then free its parameters; returns the path
    kernel's launches in the serve and long-prefill runs."""
    import gc
    cfg, params = phase_params(torch, arch, n_params)
    launches = phase_serve(torch, cfg, params)
    long = phase_long_prefill(torch, cfg, params)
    if profile:
        phase_profile(torch, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    line("freed", {"arch": arch,
                   "allocated_bytes": torch.cuda.memory_allocated()})
    return launches, long[f"{_path_kernel(cfg)}_launches"]


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
    scan_checks = phase_scan_kernels(torch)
    profile = "--profile" in sys.argv[1:]
    # the two parameter sets (29 GB and 30.5 GB) are on the card one at a
    # time
    scan_launches = sum(phase_model(torch, ARCH, N_PARAMS, profile))
    flash_checks = phase_flash_kernels(torch)
    flash_launches = sum(phase_model(torch, DENSE_ARCH, DENSE_N_PARAMS,
                                     profile))

    def entry(kernel, replaces, n, check, all_checks):
        # the headline check's source: the tensor-core kernel for its wgmma
        # route, the CUDA-core one otherwise
        stem = kernel + ("_wgmma" if check.get("route") == "wgmma" else "")
        return {"name": kernel, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{stem}.cu",
                "replaces": replaces, "launches": n,
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
    # the dense path's longest launch: the long prefill in its compute type
    long_check = next(c for c in flash_checks
                      if c["dtype"] == "bfloat16"
                      and c["shape"][3] == LONG_PROMPT)
    print(json.dumps({"kernels": [
        entry("matmul", "src/repro/kernels/matmul_pallas.py:45", launches,
              main_check, checks),
        entry("ssm_scan", "src/repro/kernels/ssm_scan.py:48", scan_launches,
              decode_check, scan_checks),
        entry("flash_attention", "src/repro/kernels/flash_attention.py:76",
              flash_launches, long_check, flash_checks)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

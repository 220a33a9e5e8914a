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
   bfloat16, with CUDA-event times beside the card's bound; also the
   states it keeps for training (the state before every 16 steps) against
   the plain version's, and its time keeping them;
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
   causal), one with D = 72, and zamba2-7b's long and served prefills
   (q 1x32x2048x112 and 1x32x12x112, 32 kv heads; phase 12): float32
   (the simt route), bf16 (wgmma) and bf16 through the simt route (q, k,
   v one element past a 16-byte boundary), each launched twice (the same
   bits), with CUDA-event times of the kernel, the plain version and
   ``scaled_dot_product_attention`` beside the card's bound, and the route
   of each check;
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
   within the prefill (CUDA events around each launch);
11. train — qwen2-7b's serving parameters freed: (a) the flash-attention
   Function's gradient (the kernel's forward, a backward in torch ops)
   against autograd of the plain version at the training step's attention
   (q 2x28x2048x128, k, v 2x4x2048x128, causal) and a ragged shape
   (2x8x1000x64, 2 kv heads), in float32 (simt) and bf16 (wgmma): dq, dk,
   dv within the forward's tolerance of the largest reference entry, with
   forward + backward CUDA-event times of the Function, the plain version
   and SDPA; (b) the training launcher at ``--reduced`` on the card: the
   resume check of tests/test_launchers.py (the resumed losses equal the
   uninterrupted run's at rtol 1e-4) and ``--show-graph --backend thread``
   (the traced step's loss equals the loop's step-0 loss), every flash
   launch simt (float32 compute); (c) qwen2-7b at full width cut to 8
   layers (2,954,460,672 float32 parameters from seed 0, bf16 compute,
   selective remat) on batches of 2 x 2048 tokens: one loss-and-gradient
   with the kernel and one with the plain attention (loss, global gradient
   norm and each leaf's cosine within TRAIN_*_TOL), then 4 steps of
   launch/steps.py's train step with AdamW: finite, falling losses and 16
   wgmma flash launches a step (the forward and the remat recompute), with
   the step seconds, tokens/s, peak device memory and the flash forwards'
   device ms in each step; then the same 4 steps from the same draw with
   the plain attention, whose losses the kernel's must meet within
   TRAIN_TRAJ_TOL at every step; then Mamba1: (d) the scan's backward
   kernel against the plain gradient (autograd of the plain scan, or
   ``ref.ssm_scan_backward`` at the training shape) at falcon-mamba-7b's
   training scan (2x2048x8192, N = 16), the long prefill's (1x2048x8192),
   a ragged shape (3x1000x1000 with h0 and dh_final), N = 1 and N = 32, S
   = 1 and the reduced config's (2x16x256): every gradient within 1e-4 of
   its largest plain entry, the kernel given the forward kernel's states
   the bits of the wrapper's standalone route, two launches the same bits,
   with CUDA-event times of the backward kernel given the states, of the
   standalone route (forward kernel, then backward kernel), of the SSMScan
   Function's forward + backward and of the plain backward beside the
   card's bounds; (e) (b) for
   falcon-mamba-7b: two scan forwards and one backward kernel launch a
   layer a step; (f) (c) for falcon-mamba-7b at full width cut to 16 of
   its 64 layers (2,217,676,800 parameters): the first-step limits, 4
   steps with finite losses and 32 forward + 16 backward scan launches a
   step (with the scan's forward and backward device ms), and the same 4
   steps with the plain scan (autograd of the step-by-step loop) within
   TRAIN_TRAJ_TOL; then the first step in float32 compute within
   SCAN_F32_*, and a control, the kernel path reading Δ rounded to bf16,
   which must break the float32 limits and TRAIN_TRAJ_TOL;
12. hybrid — the training state freed, zamba2-7b at full width (81 Mamba2
   layers and one shared transformer block applied after every 6th: 13
   sites of 32 heads of 112, 6,751,130,832 float32 parameters drawn on the
   card from a seed) served by the same launcher and argv: 28 decode steps,
   the traced tokens a prefix of request 0's, 13 flash launches per
   prefill, all on the route ``route()`` gives (wgmma in bf16), none per
   decode step; then phase 7's long prefill with the kernel (13 launches)
   and with the plain attention (none), and the parameters freed.  Its
   Mamba2 (SSD) layers are torch ops: the JAX package has no kernel for
   them.

With ``--profile`` it also profiles one decode step and two prefills of
each served model (zamba2-7b's too) and one full-width training step of
each trained one (device time
by kernel, device busy share, and the device time of the port's own
kernels).

Then one JSON line of the kernels (``flash_attention``, headed by its
wgmma kernel, counts the wrapper's launches on both routes, serving and
training; ``flash_attention_simt`` is the CUDA-core kernel and its
launches; ``ssm_scan`` counts serving and training forwards, and
``ssm_scan_backward``, headed by the training shape, the backward kernel's
launches in 11e and 11f), and
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

# the serve paths: falcon-mamba-7b, qwen2-7b and zamba2-7b (phase 12) at
# full width, the JAX launcher's defaults for prompts (4-12 tokens) and
# --max-len 64
ARCH, N_PARAMS = "falcon-mamba-7b", 7_272_665_088
DENSE_ARCH, DENSE_N_PARAMS = "qwen2-7b", 7_615_616_512
HYBRID_ARCH, HYBRID_N_PARAMS = "zamba2-7b", 6_751_130_832
SERVE_ARGS = ["--requests", "4", "--slots", "2", "--max-new", "8",
              "--show-graph", "--backend", "thread"]
SERVE_MAX_LEN = 64               # serve.py's --max-len default
SERVE_DECODE_STEPS = 28          # 4 requests x 7 decode steps each
SERVE_FORWARDS = 3 + 4 + 28      # traced request + prefills + decode steps
SERVE_PREFILLS = 1 + 4           # traced request + requests
# (Bsz, S, D, N, with h0): the long prefill, one decode step and one
# served prefill (from the cache's zero state) of falcon-mamba-7b, a
# ragged shape, and the training forwards of phases 11f (2 x 2048 tokens)
# and 11e (the reduced config: 2 x 16 tokens, d_inner 256)
SCAN_SHAPES = [(1, 2048, 8192, 16, False), (1, 1, 8192, 16, True),
               (1, 12, 8192, 16, True), (3, 1000, 1000, 16, True),
               (2, 2048, 8192, 16, False), (2, 16, 256, 16, False)]
# tests/test_kernels.py's ssm tolerances (rtol = atol)
SCAN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# (B, H, KH, Sq, Sk, D, causal): qwen2-7b's long prefill and a served
# prefill, the reduced qwen2-7b's prefill (phase 9b's workers, float32),
# zamba2-7b's long and served prefills (phase 12: 32 heads of 112, no
# GQA), the attention of phase 11c's training step and of 11b's reduced
# one, a ragged shape, a cross-shaped one and one whose D is a multiple of
# 8 but not of 16
FLASH_SHAPES = [(1, 28, 4, 2048, 2048, 128, True),
                (1, 28, 4, 12, 12, 128, True),
                (1, 32, 32, 2048, 2048, 112, True),
                (1, 32, 32, 12, 12, 112, True),
                (1, 4, 2, 12, 12, 32, True),
                (2, 28, 4, 2048, 2048, 128, True),
                (2, 4, 2, 16, 16, 32, True),
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
# phase 11a: (B, H, KH, Sq, Sk, D, causal) of the flash gradient checks:
# the full-width training step's attention and a ragged shape
TRAIN_GRAD_SHAPES = [(2, 28, 4, 2048, 2048, 128, True),
                     (2, 8, 2, 1000, 1000, 64, True)]
GRAD_REPS = 5
# phase 11b: the training launcher on the card at --reduced
TRAIN_LAUNCHER_ARGS = ["--arch", "qwen2-7b", "--reduced", "--device", "cuda",
                       "--batch", "2", "--seq", "16", "--log-every", "100"]
# phase 11c: qwen2-7b at full width cut to 8 of its 28 layers, whose
# float32 parameters, gradients and AdamW moments (16 bytes a parameter,
# 47.3 GB) fit the 80 GB card with the activations of 2 x 2048 tokens
TRAIN_LAYERS, TRAIN_N_PARAMS = 8, 2_954_460_672
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 2048, 4, 3e-4
# the kernel's and the plain attention's first-step loss and gradients in
# bf16 compute: they differ by the wgmma route's bf16 rounding of P before
# P V, carried through 8 layers.  Each limit is 10-20 times what four runs
# on the H100 read, all alike: loss 1.31e-6 apart (relative), global
# gradient norm 4.78e-5, least leaf cosine 0.9999917.  Phase 11f holds the
# scan kernels to the same limits, where they read loss 5.4e-6, norm
# 3.6e-5, least cosine 0.99979 (dt_proj); in bf16 compute they cannot tell
# a scan that reads Δ rounded to bf16 (the control: 2.5e-6, 4.1e-5,
# 0.99975), so 11f also compares the first step in float32 compute below.
TRAIN_LOSS_TOL, TRAIN_NORM_TOL, TRAIN_COSINE_MIN = 2e-5, 1e-3, 0.9995
# the kernels' and the plain versions' losses at each of the TRAIN_STEPS
# steps from the same draw, relative: about 10 times the H100's reading
# for qwen2-7b (at most 9.6e-5, on the last step); falcon-mamba-7b reads
# at most 7.8e-4 (step 2) and the control at most 3.3e-3 (step 3), alike
# in every run of the same code
TRAIN_TRAJ_TOL = 1e-3
# phase 11f's first step in float32 compute, kernel against plain scan:
# the H100 reads loss 8.3e-8, norm 0, least cosine 0.9999996, so the bf16
# rounding of each layer's output carries the gap in bf16 compute.  The
# control reads 2.5e-7, 4.8e-7, 0.9999978 (dt_bias); each limit lies
# between the two readings, and the control must break all three
SCAN_F32_LOSS_TOL, SCAN_F32_NORM_TOL, SCAN_F32_COSINE_MIN = \
    1.5e-7, 2e-7, 0.999999
# phase 11d: (Bsz, S, D, N, with h0 and dh_final) of the scan gradient
# checks: falcon-mamba-7b's training step (phase 11f), the long prefill's
# scan, a ragged shape, N = 1 and N = 32, S = 1, and the reduced config's
# training scan (phase 11e: 2 x 16 tokens, d_inner 256)
SCAN_GRAD_SHAPES = [(2, 2048, 8192, 16, False), (1, 2048, 8192, 16, False),
                    (3, 1000, 1000, 16, True), (2, 300, 1000, 1, True),
                    (2, 300, 1000, 32, True), (2, 1, 8192, 16, True),
                    (2, 16, 256, 16, False)]
SCAN_GRAD_TOL = SCAN_TOL["float32"]   # of each gradient's largest entry
# above this many (batch row, step, channel) cells the plain gradient is
# ref.ssm_scan_backward: autograd of the plain loop would keep GBs of
# per-step tensors
SCAN_AUTOGRAD_CELLS = 2048 * 8192
GRAD_NAMES = ("dx", "ddt", "dB", "dC", "dA", "dh0")
# phase 11f: falcon-mamba-7b at full width cut to 16 of its 64 layers:
# 35.5 GB of float32 parameters, gradients and AdamW moments (49.0 GB at 24
# layers, 116.4 GB at 64)
MAMBA_TRAIN_LAYERS, MAMBA_TRAIN_N_PARAMS = 16, 2_217_676_800


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
                   "ssm_scan_bwd.cu", "flash_attention.cu",
                   "flash_attention_wgmma.cu"} or \
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
            states = scan.ssm_scan(*args, return_states=True)[2]
            want_y, want_h, want_states = ref.ssm_scan(*args,
                                                       return_states=True)
            torch.cuda.synchronize()
            tol = SCAN_TOL[dname]
            err_y = (y.float() - want_y.float()).abs().max().item()
            err_h = (h - want_h).abs().max().item()
            # the states are float32 from inputs widened exactly: the
            # float32 tolerance in either input type
            err_s = (states - want_states).abs().max().item()
            ok = (y.dtype == dtype and h.dtype == torch.float32
                  and torch.allclose(y.float(), want_y.float(), rtol=tol,
                                     atol=tol)
                  and torch.allclose(h, want_h, rtol=tol, atol=tol)
                  and torch.allclose(states, want_states,
                                     rtol=SCAN_TOL["float32"],
                                     atol=SCAN_TOL["float32"]))
            if not ok:
                fail(f"ssm_scan {dname} {(Bsz, S, D, N)} h0={with_h0}: "
                     f"kernel disagrees with the plain version, max |err| "
                     f"y {err_y}, h_final {err_h}, states {err_s}")
            b_ms, b_by = scan_bound(Bsz, S, D, N, dtype.itemsize, with_h0)
            checks.append({
                "shape": [Bsz, S, D, N], "h0": with_h0, "dtype": dname,
                "max_abs_err": max(err_y, err_h), "max_abs_err_y": err_y,
                "max_abs_err_h": err_h, "max_abs_err_states": err_s,
                "tol": tol,
                "ms": cuda_ms(torch, lambda: scan.ssm_scan(
                    *args, return_state=True)),
                "states_ms": cuda_ms(torch, lambda: scan.ssm_scan(
                    *args, return_states=True)),
                "plain_ms": cuda_ms(torch, lambda: ref.ssm_scan(
                    *args, return_state=True), reps=2 if S > 64 else REPS),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
            print(f"ssm_scan {dname} {Bsz}x{S}x{D} N={N} h0={with_h0}: "
                  f"err {checks[-1]['max_abs_err']:.3g} (tol {tol}) | "
                  f"kernel {checks[-1]['ms']:.4f} ms, keeping the states "
                  f"{checks[-1]['states_ms']:.4f} ms | plain "
                  f"{checks[-1]['plain_ms']:.3f} ms | bound {b_ms:.4f} ms "
                  f"({b_by})", flush=True)
            del args, y, h, states, want_y, want_h, want_states
    line("ssm_scan_vs_plain", checks)
    return checks


def flash_bound(B: int, H: int, KH: int, Sq: int, Sk: int, D: int,
                causal: bool, dtype: str, itemsize: int,
                backward: bool = False):
    """Least time the card could take for one attention: 4 * D operations
    (the two products) per visible (query, key) pair at the input type's
    peak, or q, k, v read once and the output written once at HBM
    bandwidth.  Under the top-left causal mask query i sees min(i + 1, Sk)
    keys.  With ``backward``, forward and backward: 10 * D more operations
    a pair (S recomputed, dV, dP, dQ, dK), and q, k, v, dO read and out,
    dq, dk, dv written."""
    if causal:
        n = min(Sq, Sk)
        pairs = n * (n + 1) // 2 + max(Sq - Sk, 0) * Sk
    else:
        pairs = Sq * Sk
    ops_ms = (14.0 if backward else 4.0) * D * pairs * B * H \
        / PEAK_FLOPS[dtype] * 1e3
    nbytes = itemsize * (4 if backward else 2) * (B * H * Sq * D
                                                  + B * KH * Sk * D)
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
                       if "mamba" in cfg.layer_plan[0] else {}),
                    **({"ssm_heads": cfg.n_ssm_heads,
                        "ssm_head_dim": cfg.ssm_head_dim,
                        "chunk": cfg.ssm_chunk}
                       if "mamba2" in cfg.layer_plan[0] else {}),
                    **({"attention_sites": _kernel_layers(cfg),
                        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                        "head_dim": cfg.head_dim, "d_ff": cfg.d_ff}
                       if _path_kernel(cfg) == "flash_attention" else {})})
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
PORT_KERNEL = re.compile(r"\b(matmul|matmul_wgmma|ssm_scan|ssm_scan_bwd|"
                         r"flash_attention|"
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
    forward), flash attention for the dense transformer and the hybrid's
    shared-attention sites (every prefill)."""
    return "ssm_scan" if cfg.layer_plan[0] == "mamba1" else "flash_attention"


def _kernel_layers(cfg) -> int:
    """The layers that launch the path kernel once a forward (scan) or a
    prefill (flash): every Mamba1 layer, every attention site (each layer of
    the dense transformer, zamba2's 13 shared-attention sites)."""
    if _path_kernel(cfg) == "ssm_scan":
        return cfg.n_layers
    return sum("attn" in p for p in cfg.layer_plan)


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
    want[kernel] = _kernel_layers(cfg) * per
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
    want[kernel] = _kernel_layers(cfg) * per
    if launches != want:
        fail(f"{what}: kernel launches in this process {launches}, "
             f"expected {want}")
    stats = out["graph_stats"]
    ran = {k: stats["tasks_run"].get(k, 0) for k in ("prefill", "decode")}
    if ran != {"prefill": 1, "decode": 2}:
        fail(f"{what}: the workers ran {ran}, expected 1 prefill and 2 "
             f"decodes")
    in_workers = stats["kernel_launches"]
    n = _kernel_layers(cfg) * (3 if kernel == "ssm_scan" else 1)
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
    want[kernel] = _kernel_layers(cfg) * per
    if launches != want:
        fail(f"{what}: kernel launches in this process {launches}, "
             f"expected {want}")
    stats = out["graph_stats"]
    ran = {k: stats["tasks_run"].get(k, 0) for k in ("prefill", "decode")}
    if ran != {"prefill": 1, "decode": 2} or stats["tenant"] != "serve":
        fail(f"{what}: the job ran {ran} as {stats['tenant']!r}, expected 1 "
             f"prefill and 2 decodes as 'serve'")
    in_workers = stats["kernel_launches"]
    n = _kernel_layers(cfg) * (3 if kernel == "ssm_scan" else 1)
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
    want = _kernel_layers(cfg) * (1 + LONG_DECODE
                                  if counter.__name__ == "ssm_scan" else 1)
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


def profile_line(torch, tag: str, fn) -> None:
    """One call of ``fn`` under ``torch.profiler``: prints the device time
    of each kernel name, the port's own kernels wherever they rank, and the
    device's busy share of the host-clock wall (to a ``synchronize()``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's own entries (kernels, copies, sets): their self device
    # times add up to the time the device was busy
    kernels = [(e.self_device_time_total, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(reverse=True)
    busy_us = sum(k[0] for k in kernels)
    line(tag, {
        "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernel_launches": sum(k[1] for k in kernels),
        "top": [{"kernel": k[2][:120], "count": k[1],
                 "device_ms": k[0] / 1e3} for k in kernels[:12]],
        "port_kernels": [{"kernel": k[2][:120], "count": k[1],
                          "device_ms": k[0] / 1e3} for k in kernels
                         if PORT_KERNEL.search(k[2])]})


def phase_profile(torch, cfg, params) -> None:
    """Where a serve path's device time goes (``--profile`` only): one
    decode step, one served-size prefill and one LONG_PROMPT prefill, each
    after a warm-up call, through :func:`profile_line`."""
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
        profile_line(torch, f"profile_{cfg.name}_{name}", fn)


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


def phase_hybrid(torch, profile: bool) -> collections.Counter:
    """Phase 12: zamba2-7b drawn on the card at full width, served, its long
    prefill run with the flash kernel and with the plain attention (with
    ``profile``, profiled), and its parameters freed; returns the flash
    launches by route.  The process-backend and gateway phases of
    :func:`phase_model` are left out: their workers serve the reduced
    config, whose 4 layers hold no shared-attention site."""
    import gc
    cfg, params = phase_params(torch, HYBRID_ARCH, HYBRID_N_PARAMS)
    launches, _ = phase_serve(torch, cfg, params)
    launches += phase_long_prefill(torch, cfg, params)["routes"]
    if profile:
        phase_profile(torch, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    line("freed", {"arch": HYBRID_ARCH,
                   "allocated_bytes": torch.cuda.memory_allocated()})
    return launches


def _rel_err(got, want) -> float:
    """Largest |got - want| over the largest |want|: gradient checks are
    scaled by the reference gradient's own size."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def _grad_inputs(torch, gen, B, H, KH, Sq, Sk, D, dtype):
    q = torch.randn(B, H, Sq, D, generator=gen, device="cuda")
    k = torch.randn(B, KH, Sk, D, generator=gen, device="cuda")
    v = torch.randn(B, KH, Sk, D, generator=gen, device="cuda")
    dout = torch.randn(B, H, Sq, D, generator=gen, device="cuda")
    return [t.to(dtype) for t in (q, k, v)], dout.to(dtype)


def phase_train_grads(torch) -> list:
    """Phase 11a: the flash Function's gradient (kernel forward, backward
    in torch ops) against autograd of the plain version, at each
    TRAIN_GRAD_SHAPES row in float32 (simt) and bf16 (wgmma): dq, dk, dv
    within TOL of the largest reference entry, with CUDA-event times of
    forward + backward for the Function, the plain version and SDPA (a
    yardstick only)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(2)
    checks = []
    for B, H, KH, Sq, Sk, D, causal in TRAIN_GRAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            (q, k, v), dout = _grad_inputs(torch, gen, B, H, KH, Sq, Sk, D,
                                           dtype)
            for t in (q, k, v):
                t.requires_grad_()
            path = fa.route(dtype, D)
            what = (f"flash gradient {dname} {(B, H, KH, Sq, Sk, D)} "
                    f"({path})")

            def fwd_bwd(attn):
                return torch.autograd.grad(attn(q, k, v), (q, k, v), dout)

            def kernel(*a):
                return ops.flash_attention(*a, causal=causal)

            def plain(*a):
                return ref.attention(*a, causal=causal)

            def library(*a):
                return F.scaled_dot_product_attention(
                    *a, is_causal=causal, enable_gqa=True)

            before = fa.flash_attention.route_launches[path]
            got = fwd_bwd(kernel)
            torch.cuda.synchronize()
            if fa.flash_attention.route_launches[path] != before + 1:
                fail(f"{what}: the Function made no {path} launch")
            want = fwd_bwd(plain)
            errs = {n: _rel_err(g, w) for n, g, w in zip("qkv", got, want)}
            if any(g.dtype != dtype for g in got) or \
                    max(errs.values()) > TOL[dname]:
                fail(f"{what}: gradients {errs} relative to the plain "
                     f"version's largest, tolerance {TOL[dname]}")
            del got, want
            b_ms, b_by = flash_bound(B, H, KH, Sq, Sk, D, causal, dname,
                                     dtype.itemsize, backward=True)
            checks.append({
                "shape": [B, H, KH, Sq, Sk, D], "causal": causal,
                "dtype": dname, "route": path,
                "rel_err": errs, "tol": TOL[dname],
                "bound_ms": b_ms, "bound_by": b_by,
                "ms": cuda_ms(torch, lambda: fwd_bwd(kernel), GRAD_REPS),
                "plain_ms": cuda_ms(torch, lambda: fwd_bwd(plain), GRAD_REPS),
                "library_ms": cuda_ms(torch, lambda: fwd_bwd(library),
                                      GRAD_REPS)})
            c = checks[-1]
            print(f"{what}: rel err {max(errs.values()):.3g} (tol "
                  f"{TOL[dname]}) | fwd+bwd {c['ms']:.3f} ms | plain "
                  f"{c['plain_ms']:.3f} ms | sdpa {c['library_ms']:.3f} ms | "
                  f"bound {b_ms:.4f} ms ({b_by})", flush=True)
            del q, k, v, dout
    line("train_grads", checks)
    return checks


def scan_grad_bound(Bsz: int, S: int, D: int, N: int, with_states: bool,
                    given_states: bool = False):
    """Least time the card could take for one scan backward in float32:
    x, dt, dy, B, C, A (and h0, dh_final; with ``given_states`` the
    forward's states, one every 16 steps) read once and dx, ddt, dB, dC,
    dA, dh0 written once at HBM bandwidth; or 20 float32 operations per
    state element and step (the recomputed forward's 7, the exp counted as
    one, and the backward's 13) at the CUDA cores' float32 peak."""
    nbytes = 4 * (5 * Bsz * S * D + 4 * Bsz * S * N + 2 * D * N
                  + (3 if with_states else 1) * Bsz * D * N
                  + (Bsz * -(-S // 16) * D * N if given_states else 0))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 20.0 * Bsz * S * D * N / PEAK_FLOPS["float32"] * 1e3
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms, "bytes")


def _plain_scan_autograd(torch, x, dt, B, C, A, h0, dy, dh):
    """(dx, ddt, dB, dC, dA, dh0) by autograd of ref.ssm_scan."""
    from repro_torch.kernels import ref
    ins = [t.detach().clone().requires_grad_() for t in (x, dt, B, C, A)]
    state = (h0 if h0 is not None else torch.zeros(
        x.shape[0], x.shape[2], A.shape[1], device=x.device))
    state = state.detach().clone().requires_grad_()
    y, h = ref.ssm_scan(*ins, state, return_state=True)
    outs, grads = ((y, h), (dy, dh)) if dh is not None else ((y,), (dy,))
    return torch.autograd.grad(outs, ins + [state], grads)


def phase_scan_grads(torch) -> list:
    """Phase 11d: the scan's backward kernel against the plain gradient at
    each SCAN_GRAD_SHAPES row, in float32 (the model widens the scan's
    inputs): autograd of ref.ssm_scan, or ref.ssm_scan_backward above
    SCAN_AUTOGRAD_CELLS.  Every gradient within SCAN_GRAD_TOL of its
    largest plain entry; the kernel given the forward kernel's states (as
    SSMScan gives them) the same bits as the wrapper's standalone route
    (which launches the forward kernel for them), and two launches the
    same bits.  CUDA-event times (mean of REPS after a warm-up) of the
    backward kernel given the states (``ms``: its launch and the sum of its
    partials), of the standalone route, of the SSMScan Function's forward
    + backward and of the plain backward given the same states
    (ref.ssm_scan_backward), beside the card's bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref, ssm_scan as scan
    from repro_torch.models.layers import ParamSpec, init_param
    gen = torch.Generator(device="cuda").manual_seed(3)
    dev = torch.device("cuda")
    checks = []
    for Bsz, S, D, N, with_states in SCAN_GRAD_SHAPES:
        # dt and A as the model makes them (see phase_scan_kernels)
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
        dy = torch.randn(Bsz, S, D, generator=gen, device=dev)
        h0, dh = ((torch.randn(Bsz, D, N, generator=gen, device=dev),
                   torch.randn(Bsz, D, N, generator=gen, device=dev))
                  if with_states else (None, None))
        args = (x, dt, B, C, A, h0, dy, dh)
        what = f"ssm_scan gradient {(Bsz, S, D, N)} states={with_states}"
        before = scan.ssm_scan_backward.launches
        states = scan.ssm_scan(x, dt, B, C, A, h0, return_states=True)[2]
        got = scan.ssm_scan_backward(*args, states=states)
        again = scan.ssm_scan_backward(*args, states=states)
        alone = scan.ssm_scan_backward(*args)
        torch.cuda.synchronize()
        if scan.ssm_scan_backward.launches != before + 3:
            fail(f"{what}: no backward kernel launch")
        if not all(_same(torch, g, a) for g, a in zip(got, again)):
            fail(f"{what}: two launches gave different bits")
        if not all(_same(torch, g, a) for g, a in zip(got, alone)):
            fail(f"{what}: given the forward's states, the kernel gave "
                 f"other bits than the standalone route")
        del again, alone
        autograd = Bsz * S * D <= SCAN_AUTOGRAD_CELLS
        want = (_plain_scan_autograd(torch, *args) if autograd
                else ref.ssm_scan_backward(*args))
        errs = {n: _rel_err(g, w) for n, g, w in zip(GRAD_NAMES, got, want)}
        abs_err = max((g - w).abs().max().item() for g, w in zip(got, want))
        if any(g.dtype != torch.float32 or g.shape != w.shape
               for g, w in zip(got, want)) or \
                max(errs.values()) > SCAN_GRAD_TOL:
            fail(f"{what}: gradients {errs} relative to the plain "
                 f"version's largest, tolerance {SCAN_GRAD_TOL}")
        del got, want
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, dt, B, C, A)]
        state = None if h0 is None else h0.detach().clone().requires_grad_()

        def function():
            y, h = scan.SSMScan.apply(*leaves, state)
            outs, grads = ((y, h), (dy, dh)) if dh is not None \
                else ((y,), (dy,))
            return torch.autograd.grad(
                outs, leaves + ([state] if state is not None else []), grads)
        b_ms, b_by = scan_grad_bound(Bsz, S, D, N, with_states, True)
        alone_ms, alone_by = scan_grad_bound(Bsz, S, D, N, with_states)
        checks.append({
            "shape": [Bsz, S, D, N], "states": with_states,
            "dtype": "float32",
            "plain": "autograd" if autograd else "ref.ssm_scan_backward",
            "rel_err": errs, "max_abs_err": abs_err, "tol": SCAN_GRAD_TOL,
            "same_bits": True,
            "ms": cuda_ms(torch, lambda: scan.ssm_scan_backward(
                *args, states=states)),
            "standalone_ms": cuda_ms(
                torch, lambda: scan.ssm_scan_backward(*args)),
            "function_ms": cuda_ms(torch, function),
            "plain_ms": cuda_ms(torch, lambda: ref.ssm_scan_backward(
                *args, states=states)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "standalone_bound_ms": alone_ms, "standalone_bound_by": alone_by})
        c = checks[-1]
        print(f"{what}: rel err {max(errs.values()):.3g} (tol "
              f"{SCAN_GRAD_TOL}; plain {c['plain']}) | backward kernel "
              f"given the states {c['ms']:.4f} ms (bound {b_ms:.4f} ms, "
              f"{b_by}) | standalone {c['standalone_ms']:.4f} ms (bound "
              f"{alone_ms:.4f} ms, {alone_by}) | Function fwd+bwd "
              f"{c['function_ms']:.4f} ms | plain backward "
              f"{c['plain_ms']:.3f} ms", flush=True)
        del args, leaves, state, states, x, dt, B, C, dy, h0, dh
    line("scan_grads", checks)
    return checks


def _train_kernels(cfg) -> dict:
    """A model path's training kernels: each wrapper and its launches a
    layer a step under selective remat.  Flash attention's forward runs
    twice (the forward and the recompute); so does the scan's, and its
    backward kernel once."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as scan
    if _path_kernel(cfg) == "flash_attention":
        return {fa.flash_attention: 2}
    return {scan.ssm_scan: 2, scan.ssm_scan_backward: 1}


def phase_train_launcher(torch, arch: str = DENSE_ARCH) -> dict:
    """Phase 11b (qwen2-7b) and 11e (falcon-mamba-7b): the training
    launcher on the card at ``--reduced``: tests/test_launchers.py's resume
    check (8 steps with a checkpoint every 5, an uninterrupted run to 12, a
    run resumed from step 5), then ``--show-graph --backend thread`` (the
    traced step's loss equals the loop's step-0 loss).  The reduced configs
    compute in float32, so every flash launch is simt.  Every path kernel
    launches its ``_train_kernels`` count a layer a step.  Returns each
    path kernel's launches by route, by wrapper name."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    cfg = get_config(arch).reduced()
    argv = ["--arch", arch] + TRAIN_LAUNCHER_ARGS[2:]
    kernels = _train_kernels(cfg)
    for fn in kernels:
        _reset(fn)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        ck = os.path.join(tmp, "ck")
        base = argv + ["--ckpt-every", "5"]
        t0 = time.perf_counter()
        r1 = train.main(base + ["--ckpt-dir", ck, "--steps", "8"])
        r_full = train.main(base + ["--ckpt-dir", os.path.join(tmp, "ref"),
                                    "--steps", "12"])
        r2 = train.main(base + ["--ckpt-dir", ck, "--steps", "12",
                                "--resume"])
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    import numpy as np
    if not (np.isfinite(r1["losses"]).all()
            and np.isfinite(r_full["losses"]).all()):
        fail(f"non-finite launcher losses {r1['losses']} {r_full['losses']}")
    if r2["start_step"] != 6 or not np.allclose(
            r2["losses"], r_full["losses"][6:12], rtol=1e-4, atol=1e-5):
        fail(f"resumed from {r2['start_step']} with losses {r2['losses']}, "
             f"the uninterrupted run's {r_full['losses'][6:12]}")
    g = train.main(argv + ["--steps", "1", "--show-graph", "--backend",
                           "thread"])
    if g["traced_loss"] is None or not math.isclose(
            g["traced_loss"], g["losses"][0], rel_tol=1e-4):
        fail(f"traced step loss {g['traced_loss']} != the loop's step-0 "
             f"loss {g['losses'][0]}")
    train._demo_runtime.cache_clear()
    steps_run = 8 + 12 + 6 + 1 + 1          # the last run: loop + traced
    path = next(iter(kernels))
    routes = _check_routes(path, cfg, "reduced train launcher")
    for fn, per_layer in kernels.items():
        want = per_layer * cfg.n_layers * steps_run
        if fn.launches != want:
            fail(f"reduced train launcher: {fn.launches} {fn.__name__} "
                 f"launches, expected {want}")
    line("train_launcher", {
        "argv": argv, "layers": cfg.n_layers,
        "compute_dtype": cfg.compute_dtype, "steps_run": steps_run,
        "losses_8": r1["losses"], "losses_12": r_full["losses"],
        "resumed_losses": r2["losses"], "resume_s": resume_s,
        "traced_loss": g["traced_loss"], "loop_step0_loss": g["losses"][0],
        **({"flash_launches": path.launches}
           if _path_kernel(cfg) == "flash_attention" else {}),
        "launches": {fn.__name__: fn.launches for fn in kernels},
        "launches_by_route": routes})
    return {fn.__name__: _launch_routes(fn) for fn in kernels}


@contextlib.contextmanager
def timed_function_calls(torch, fn_cls, method: str = "forward"):
    """Within the block, every call of the autograd Function ``fn_cls``'s
    ``method`` (``forward``: its kernel launch and output allocation;
    ``backward``) is bracketed by CUDA events; yields the list of (start,
    end) pairs."""
    inner = getattr(fn_cls, method)
    events = []

    def timed(ctx, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(ctx, *args)
        end.record()
        events.append((start, end))
        return out

    setattr(fn_cls, method, staticmethod(timed))
    try:
        yield events
    finally:
        setattr(fn_cls, method, staticmethod(inner))


def _first_step_gap(torch, got, want) -> dict:
    """The gap between two first-step (loss, {leaf path: gradient}) pairs:
    the losses' and global gradient norms' relative differences and each
    leaf's cosine.  The key bias's gradient is 0 in exact arithmetic (q·bk
    shifts every key's score alike), so both are rounding noise: its cosine
    is reported and not compared."""
    from repro_torch.optim import global_norm
    norms = [global_norm(g).item() for _, g in (got, want)]
    cosines = {}
    for path, gg in got[1].items():
        gg, gw = gg.float().flatten(), want[1][path].float().flatten()
        cosines[path] = (torch.dot(gg, gw) / (gg.norm() * gw.norm())
                         .clamp_min(1e-30)).item()
    compared = {p: c for p, c in cosines.items() if not p.endswith("/bk")}
    least = min(compared, key=compared.get)
    return {"loss_rel_diff": abs(got[0] - want[0]) / abs(want[0]),
            "grad_norms": norms,
            "grad_norm_rel_diff": abs(norms[0] - norms[1]) / norms[1],
            "min_cosine": compared[least], "min_cosine_leaf": least,
            "cosines": cosines}


def _within_limits(gap: dict, loss_tol: float, norm_tol: float,
                   cosine_min: float) -> bool:
    """Whether a first-step gap is within the given limits."""
    return (gap["loss_rel_diff"] <= loss_tol
            and gap["grad_norm_rel_diff"] <= norm_tol
            and gap["min_cosine"] >= cosine_min)


def _outside_each_limit(gap: dict, loss_tol: float, norm_tol: float,
                        cosine_min: float) -> bool:
    """Whether a first-step gap breaks every one of the given limits."""
    return (gap["loss_rel_diff"] > loss_tol
            and gap["grad_norm_rel_diff"] > norm_tol
            and gap["min_cosine"] < cosine_min)


@contextlib.contextmanager
def _scan_reads_dt_in_bf16(torch):
    """Within the block the Mamba1 block's scan reads Δ rounded to bf16
    (the model computes it in float32): a scan of lower input precision,
    phase 11f's control."""
    from repro_torch.kernels import ops
    inner = ops.ssm_scan

    def rounded(x, dt, *args, **kwargs):
        return inner(x, dt.to(torch.bfloat16).float(), *args, **kwargs)

    ops.ssm_scan = rounded
    try:
        yield
    finally:
        ops.ssm_scan = inner


def _train_cell(arch: str):
    """Phase 11c's or 11f's model: the config cut in depth, its parameter
    count, and the autograd Function of its path kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as scan
    full = get_config(arch)
    layers, n_params, fn_cls = (
        (TRAIN_LAYERS, TRAIN_N_PARAMS, fa.FlashAttention) if arch == DENSE_ARCH
        else (MAMBA_TRAIN_LAYERS, MAMBA_TRAIN_N_PARAMS, scan.SSMScan))
    cfg = dataclasses.replace(full, n_layers=layers,
                              layer_plan=full.layer_plan[:layers])
    return cfg, n_params, fn_cls


def phase_train_full(torch, arch: str = DENSE_ARCH,
                     profile: bool = False) -> dict:
    """Phase 11c (qwen2-7b at TRAIN_LAYERS layers) and 11f (falcon-mamba-7b
    at MAMBA_TRAIN_LAYERS): the published width cut in depth (bf16
    compute, selective remat), drawn on the card from seed 0, trained on
    SyntheticLMDataset(seed=0) batches of TRAIN_BATCH x TRAIN_SEQ.  First
    one loss-and-gradient with the kernels and one with the plain versions
    on the same parameters and batch; then TRAIN_STEPS steps of
    launch/steps.py's train step with make_optimizer's AdamW; with
    ``profile``, one more step under the profiler; then the same steps from
    the same draw with the plain versions, whose losses the kernels' steps
    must meet.  The dense model's losses must also fall over the steps.
    The Mamba1 cell also reads the first step in float32 compute, kernel
    and plain (within SCAN_F32_*), and a control, the kernel path reading
    Δ rounded to bf16: its first step in both computes and its steps from
    the same draw, which must break the float32 limits and TRAIN_TRAJ_TOL.
    Returns each path kernel's launches in the measured steps by route, by
    wrapper name."""
    import gc
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch import steps
    from repro_torch.models import transformer as TF
    from repro_torch.optim.schedules import cosine_schedule
    from repro_torch.tree import tree_flatten_with_paths
    cfg, n_params, fn_cls = _train_cell(arch)
    dense = _path_kernel(cfg) == "flash_attention"
    if (cfg.compute_dtype, cfg.remat) != ("bfloat16", "selective"):
        fail(f"{cfg.name}: expected bf16 compute and selective remat")
    kernels = _train_kernels(cfg)
    counter = next(iter(kernels))                # the forward kernel
    per_step = {fn: k * cfg.n_layers for fn, k in kernels.items()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = TF.init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n = sum(t.numel() for _, t in tree_flatten_with_paths(params))
    if n != n_params or n != TF.count_params(cfg):
        fail(f"{cfg.name} at {cfg.n_layers} layers: {n} parameters, "
             f"expected {n_params}")
    ds = SyntheticLMDataset(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)

    def batch_at(s):
        return {k: torch.as_tensor(v, device="cuda")
                for k, v in ds.batch_at(s).items()}

    def launched():
        return {fn.__name__: fn.launches for fn in kernels}

    def first_step(run_cfg, impl="kernel"):
        t0 = time.perf_counter()
        (total, _), g = TF.value_and_grad(TF.make_loss_fn(
            run_cfg, impl=impl))(params, batch_at(0))
        return (total.item(), dict(tree_flatten_with_paths(g)),
                time.perf_counter() - t0)

    # the kernels' and the plain versions' first-step gradients
    grads, losses, first_s = {}, {}, {}
    for impl in ("kernel", "ref"):
        for fn in kernels:
            _reset(fn)
        losses[impl], grads[impl], first_s[impl] = first_step(cfg, impl)
        want = {fn.__name__: (k if impl == "kernel" else 0)
                for fn, k in per_step.items()}
        if launched() != want:
            fail(f"{impl} loss-and-gradient: launches {launched()}, "
                 f"expected {want}")
    plain = (losses["ref"], grads["ref"])
    gap = _first_step_gap(torch, (losses["kernel"], grads["kernel"]), plain)
    witness = {}
    if not dense:
        # the Mamba1 cell's gap, read three times more: the control (the
        # kernel path reading Δ rounded to bf16), and the kernel and the
        # control in float32 compute, where no bf16 rounding of a layer's
        # output carries a last-bit difference through the depth
        del grads["kernel"]
        with _scan_reads_dt_in_bf16(torch):
            loss, g, seconds = first_step(cfg)
        witness["control"] = {**_first_step_gap(torch, (loss, g), plain),
                              "seconds": seconds}
        del g, grads, plain
        gc.collect()
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        plain = first_step(cfg32, "ref")
        for name in ("float32", "float32_control"):
            with (_scan_reads_dt_in_bf16(torch) if name.endswith("control")
                  else contextlib.nullcontext()):
                loss, g, seconds = first_step(cfg32)
            witness[name] = {**_first_step_gap(torch, (loss, g), plain[:2]),
                             "seconds": [seconds, plain[2]]}
            del g
        del plain
    else:
        del grads, plain
    gc.collect()
    torch.cuda.empty_cache()
    if not (math.isfinite(losses["kernel"]) and _within_limits(
            gap, TRAIN_LOSS_TOL, TRAIN_NORM_TOL, TRAIN_COSINE_MIN)):
        fail(f"kernel vs plain first step: losses {losses}, {gap}")

    compare_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # warmup 1, so that 4 steps train at the peak rate and below; with the
    # launcher's default warmup of 10 the rate is at most 1.2e-4 there
    opt = steps.make_optimizer(cfg, lr=cosine_schedule(
        TRAIN_LR, 1, TRAIN_STEPS))
    state = opt.init(params)
    step = steps.make_train_step(cfg, opt)
    step_losses, step_s, fwd_ms, bwd_ms = [], [], [], []
    for fn in kernels:
        _reset(fn)
    for s in range(TRAIN_STEPS):
        batch = batch_at(s)
        torch.cuda.synchronize()
        with contextlib.ExitStack() as timing:
            fwd = timing.enter_context(
                timed_function_calls(torch, fn_cls))
            bwd = (None if dense else timing.enter_context(
                timed_function_calls(torch, fn_cls, "backward")))
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            step_losses.append(metrics["total_loss"].item())
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        fwd_ms.append(events_ms(torch, fwd))
        if bwd is not None:
            bwd_ms.append(events_ms(torch, bwd))
        want = {fn.__name__: k * (s + 1) for fn, k in per_step.items()}
        if len(fwd) != per_step[counter] or launched() != want:
            fail(f"train step {s}: {len(fwd)} {fn_cls.__name__} forwards, "
                 f"launches so far {launched()}, expected {want}")
    routes = dict(_check_routes(counter, cfg, f"{cfg.name} train steps")
                  or {"simt": counter.launches})
    if not all(math.isfinite(x) for x in step_losses) or \
            (dense and not step_losses[-1] < step_losses[0]):
        fail(f"train losses {step_losses}: not finite"
             + (" and falling" if dense else ""))
    median_s = sorted(step_s[1:])[len(step_s[1:]) // 2]
    steps_peak = torch.cuda.max_memory_allocated()
    step_launches = launched()
    launches = {fn.__name__: _launch_routes(fn) for fn in kernels}
    if profile:
        batch = batch_at(TRAIN_STEPS)
        profile_line(torch, f"profile_{cfg.name}_train_step",
                     lambda: step(params, state, batch))
    del params, state, metrics, step
    gc.collect()
    torch.cuda.empty_cache()

    # the same steps from the same draw with the plain versions: the train
    # step's body (launch/steps.py) over make_loss_fn(impl="ref")
    torch.cuda.reset_peak_memory_stats()
    params = TF.init_params(cfg, 0, "cuda")
    opt = steps.make_optimizer(cfg, lr=cosine_schedule(
        TRAIN_LR, 1, TRAIN_STEPS))
    state = opt.init(params)
    plain_grad_fn = TF.value_and_grad(TF.make_loss_fn(cfg, impl="ref"))
    plain_losses, plain_s = [], []
    for fn in kernels:
        _reset(fn)
    for s in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        (total, _), g = plain_grad_fn(params, batch_at(s))
        state = opt.update(g, state, params)
        plain_losses.append(total.item())
        plain_s.append(time.perf_counter() - t0)
        del g
    if any(launched().values()):
        fail(f"plain train steps: launches {launched()}")
    plain_peak = torch.cuda.max_memory_allocated()
    traj_diff = [abs(k - p) / abs(p) for k, p in zip(step_losses,
                                                      plain_losses)]
    if not all(math.isfinite(x) for x in plain_losses) or \
            max(traj_diff) > TRAIN_TRAJ_TOL:
        fail(f"train losses: kernel {step_losses}, plain {plain_losses}, "
             f"relative differences {traj_diff} (limit {TRAIN_TRAJ_TOL})")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    if not dense:
        # the control's steps: the kernel path reading Δ in bf16, from the
        # same draw, against the plain steps
        params = TF.init_params(cfg, 0, "cuda")
        opt = steps.make_optimizer(cfg, lr=cosine_schedule(
            TRAIN_LR, 1, TRAIN_STEPS))
        state = opt.init(params)
        step = steps.make_train_step(cfg, opt)
        control_losses = []
        with _scan_reads_dt_in_bf16(torch):
            for s in range(TRAIN_STEPS):
                params, state, metrics = step(params, state, batch_at(s))
                control_losses.append(metrics["total_loss"].item())
        witness["control"]["losses"] = control_losses
        witness["control"]["losses_rel_diff"] = [
            abs(c - p) / abs(p) for c, p in zip(control_losses,
                                                 plain_losses)]
        del params, state, metrics, step
        gc.collect()
        torch.cuda.empty_cache()
    dims = ({"heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
             "d_ff": cfg.d_ff} if dense else
            {"d_inner": cfg.d_inner, "state": cfg.ssm_state})
    timings = ({"flash_launches": step_launches["flash_attention"],
                "launches_by_route": routes,
                "flash_forward_ms_per_step": fwd_ms} if dense else
               {"launches": step_launches,
                "scan_forward_ms_per_step": fwd_ms,
                "scan_backward_ms_per_step": bwd_ms,
                "first_step_s": first_s, "plain_step_s": plain_s,
                "witness": witness})
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "n_params": n,
        "d_model": cfg.d_model, **dims,
        "vocab": cfg.vocab_size, "compute_dtype": cfg.compute_dtype,
        "remat": cfg.remat, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "lr": TRAIN_LR, "draw_s": draw_s,
        "first_step": {"loss_kernel": losses["kernel"],
                       "loss_plain": losses["ref"], **gap,
                       "loss_tol": TRAIN_LOSS_TOL,
                       "grad_norm_tol": TRAIN_NORM_TOL,
                       "cosine_min_allowed": TRAIN_COSINE_MIN},
        "losses": step_losses, "plain_losses": plain_losses,
        "losses_rel_diff": traj_diff, "losses_tol": TRAIN_TRAJ_TOL,
        "step_s": step_s,
        "median_step_s": median_s,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median_s,
        **timings,
        # the training steps' peak, the first-step comparison's (two
        # gradient trees at once) and the plain versions' steps'
        "peak_device_bytes": steps_peak,
        "peak_device_bytes_compare": compare_peak,
        "peak_device_bytes_plain_steps": plain_peak}
    line("train_full", out)
    if not dense:
        f32 = (SCAN_F32_LOSS_TOL, SCAN_F32_NORM_TOL, SCAN_F32_COSINE_MIN)
        if not _within_limits(witness["float32"], *f32):
            fail(f"kernel vs plain first step in float32 compute: "
                 f"{witness['float32']}, limits {f32}")
        if not _outside_each_limit(witness["float32_control"], *f32) or \
                max(witness["control"]["losses_rel_diff"]) <= TRAIN_TRAJ_TOL:
            fail(f"the limits do not tell a scan reading Δ in bf16: "
                 f"{witness['float32_control']}, trajectory "
                 f"{witness['control']['losses_rel_diff']}")
    return launches


def main() -> int:
    import gc

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
    # phase 11, training: qwen2-7b's serving parameters are freed by now
    phase_train_grads(torch)
    flash_launches += phase_train_launcher(torch)["flash_attention"]
    flash_launches += phase_train_full(torch, profile=profile)[
        "flash_attention"]
    # 11d-11f: Mamba1 training, through the scan's backward kernel
    scan_grad_checks = phase_scan_grads(torch)
    bwd_launches = collections.Counter()
    for run in (phase_train_launcher(torch, ARCH),
                phase_train_full(torch, ARCH, profile)):
        scan_launches += run["ssm_scan"]
        bwd_launches += run["ssm_scan_backward"]
    # phase 12: the Mamba2 hybrid, the flash kernel at its 13 sites
    gc.collect()
    torch.cuda.empty_cache()
    flash_launches += phase_hybrid(torch, profile)

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
                   if c["shape"][:4] == [1, 28, 4, LONG_PROMPT]
                   and c["aligned"]}
    # the backward kernel's headline: falcon-mamba-7b's training step
    train_scan_check = next(c for c in scan_grad_checks
                            if c["shape"][:2] == [TRAIN_BATCH, TRAIN_SEQ])
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
        # the TPU kernel has no backward: the JAX package differentiates
        # its jnp scan, selective_scan
        entry("ssm_scan_backward", "ssm_scan_bwd.cu",
              "src/repro/models/ssm.py:74", bwd_launches["simt"],
              bwd_launches, train_scan_check, scan_grad_checks),
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

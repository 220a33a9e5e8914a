#!/usr/bin/env python3
"""Find where ``chip_smoke.py``'s profiler device times stop agreeing with
CUDA events: run, in order, the phases that ``chip_smoke.main`` runs before
phase 11a, and after each time one launch shape two ways.

    python3 profiler_causes.py    # from the root of a checkout

The shape is 11c's wgmma flash backward (q 2x28x2048x128 over 4 kv heads,
bf16, causal), given the forward kernel's out and lse.  Each PROBE line
gives the median of CUDA events around each of 20 calls
(``chip_smoke.cuda_median_ms``), ``chip_smoke.device_busy_ms`` (the
profiler's kernel durations over 20 calls, divided by 20), their ratio,
and how many records of each kernel the profiler kept over 20 calls (20
each when none was dropped).  It needs one CUDA card and nvcc, and takes
about 7 minutes: the phases are chip_smoke.py's own, at their sizes.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def probe(torch, cs, state: dict, tag: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as fa
    if not state:
        gen = torch.Generator(device="cuda").manual_seed(2)
        (q, k, v), dout = cs._grad_inputs(torch, gen, 2, 28, 4, 2048, 2048,
                                          128, torch.bfloat16)
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        state["f"] = lambda: fa.flash_attention_backward(
            q, k, v, out, dout, lse, causal=True)
    f = state["f"]
    ev = cs.cuda_median_ms(torch, f)
    dev = cs.device_busy_ms(torch, f)
    f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            f()
        torch.cuda.synchronize()
    counts = {e.key[:40]: e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA}
    print(f"PROBE {tag}: events {ev:.4f} ms, device {dev:.4f} ms, ratio "
          f"{dev / ev:.3f}, kernel records {counts}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profiler_causes: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = {}
    t0 = time.perf_counter()
    cs.phase_device(torch)
    cs.phase_build()
    probe(torch, cs, state, "after build")
    checks = cs.phase_kernels(torch)
    probe(torch, cs, state, "after 3")
    _, graph, seq = cs.phase_main_path(torch, checks)
    probe(torch, cs, state, "after main path")
    cs.phase_process_path(torch, graph, seq)
    probe(torch, cs, state, "after process path")
    cs.phase_gateway_path(torch, graph, seq)
    probe(torch, cs, state, "after gateway path")
    cs.phase_scan_kernels(torch)
    probe(torch, cs, state, "after scan kernels")
    cs.phase_model(torch, cs.ARCH, cs.N_PARAMS, False)
    probe(torch, cs, state, "after mamba model")
    cs.phase_flash_kernels(torch)
    probe(torch, cs, state, "after flash kernels")
    cs.phase_model(torch, cs.DENSE_ARCH, cs.DENSE_N_PARAMS, False)
    probe(torch, cs, state, "after dense model")
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


# the process and gateway phases spawn workers that import this module
if __name__ == "__main__":
    sys.exit(main())

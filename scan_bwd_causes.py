#!/usr/bin/env python3
"""Measure what holds the scan's backward kernel: build variants of its
source, each with one cost taken out, and time each on one card.

    python3 scan_bwd_causes.py first build/ab/parent/src/repro_torch/kernels/csrc/ssm_scan_bwd.cu
    python3 scan_bwd_causes.py redesign src/repro_torch/kernels/csrc

``first``: the first kernel's ``ssm_scan_bwd.cu`` (its C entry
``repro_ssm_scan_bwd_f32`` takes a ``bounds`` scratch tensor and runs a
forward pass to fill it).  Each variant is the source with text patches;
most compute wrong gradients on purpose and serve only for their time:

- ``base``: as it is;
- ``no_pass1``: the forward pass that fills ``bounds`` skipped (``bounds``
  from the base run, so its gradients must equal the base's bits);
- ``no_exp``: every ``ex2.approx`` replaced by a move (all three exps of a
  state-step gone);
- ``no_shfl``: every ``__shfl_xor_sync`` replaced by its own value;
- ``no_loads``: the chunk staging's global loads replaced by zeros (its
  ``__syncthreads`` kept);
- ``no_partials``: the per-block ``dB_part`` / ``dC_part`` stores skipped
  (kept only for NaNs, so the compiler keeps the sums).

``redesign``: a ``csrc`` directory of the redesigned kernels, whose
forward kernel keeps the states the backward starts from.  Each variant
patches ``ssm_scan.cu`` and ``ssm_scan_bwd.cu``; the backward is timed
given the variant's forward states:

- ``base``: as they are;
- ``ch8``: states every 8 steps and chunks of 8 (half the unrolled code
  and the register history, twice the states);
- ``no_reduce``: the per-step reduce-scatters (shuffles) skipped;
- ``no_sums``: their stores skipped too (the dB and dC terms and the
  per-channel sums are then dead code);
- ``no_exp``: every ``ex2.approx`` replaced by a move;
- ``no_stores``: the chunk's dx, ddt and partial stores skipped (kept only
  for NaNs);
- ``cpb32``: blocks of 32 channels (16 at G = 8), half the threads, so two
  blocks share a SM (twice the partials).

Each variant builds into its own library under ``build/causes`` (one
``nvcc`` each, all started together).  It prints the card's ``nvidia-smi``
name and power limit, each build's ``-Xptxas -v`` line, the G = 4
kernel's blocks per SM from the occupancy API and its SASS instruction
count (``cuobjdump``), CUDA-event times (mean of ``--reps`` after a
warm-up) of each variant, of the first kernel's torch sums of its
partials, and one JSON line, also written to ``--out``.  It needs a CUDA
card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

_NAN_GUARD = ("dB_part[at] = sb;", "if (sb != sb) dB_part[at] = sb;"), \
    ("dC_part[at] = sc;", "if (sc != sc) dC_part[at] = sc;")
# variant -> [(old, new)]; a regex pair is marked by a leading "re:"
VARIANTS = {
    "base": [],
    "no_pass1": [("for (int k = 0; k < chunks; ++k) {",
                  "for (int k = 0; k < 0; ++k) {")],
    "no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));',
                "r = v;")],
    "no_shfl": [(r"re:__shfl_xor_sync\(kFull, (\w+(?:\[r\])?), w\)", r"(\1)")],
    "no_loads": [("? x[at] :", "? 0.0f :"), ("? dt[at] :", "? 0.0f :"),
                 ("? dy[at] :", "? 0.0f :"), ("? Bm[at] :", "? 0.0f :"),
                 ("? Cm[at] :", "? 0.0f :")],
    "no_partials": list(_NAN_GUARD),
}
_EXP = ('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));', "r = v;")
_REDUCE = [("      reduce_lanes<G, 16, 2 * R>(terms, lane);\n", ""),
           ("      reduce_lanes<1, G / 2, 2>(sums2, lane);\n", "")]
_NO_SUMS = _REDUCE + [
    ("      if (term_writes) {", "      if (false) {"),
    ("      } else if (sum_writes) {", "      } else if (false) {")]
# redesign variant -> {file: [(old, new)]}
REDESIGN = {
    "base": {},
    "ch8": {"ssm_scan.cu": [("constexpr int SCH = 16;",
                             "constexpr int SCH = 8;")],
            "ssm_scan_bwd.cu": [("constexpr int CH = 16;",
                                 "constexpr int CH = 8;")]},
    "no_reduce": {"ssm_scan_bwd.cu": _REDUCE},
    "no_sums": {"ssm_scan_bwd.cu": _NO_SUMS},
    "no_exp": {"ssm_scan.cu": [_EXP], "ssm_scan_bwd.cu": [_EXP]},
    "no_stores": {"ssm_scan_bwd.cu": [
        ("dx[at] = half", "if (sgb != sgb) dx[at] = half"),
        ("ddt[at] = fmaf", "if (sgb != sgb) ddt[at] = fmaf"),
        ("(q == 0 ? dB_part", "if (v != v) (q == 0 ? dB_part")]},
    "cpb32": {"ssm_scan_bwd.cu": [(
        "static constexpr int CPB = G == 8 ? 32 : 64;",
        "static constexpr int CPB = G == 8 ? 16 : 32;")]},
}
# appended to every variant: blocks per SM of the G = 4 instantiation
_OCCUPANCY = """
extern "C" int probe_blocks_per_sm(int g) {
  int n = -1;
  if (g == 4) {
    cudaFuncSetAttribute(ssm_scan_bwd_kernel<4>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(Bwd<4>::BYTES));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, ssm_scan_bwd_kernel<4>, Bwd<4>::THREADS, Bwd<4>::BYTES);
  }
  return n;
}
"""


def patched(text: str, patches, occupancy: bool = True) -> str:
    for old, new in patches:
        if old.startswith("re:"):
            text, n = re.subn(old[3:], new, text)
        else:
            n = text.count(old)
            text = text.replace(old, new)
        if n == 0:
            raise ValueError(f"patch not found in the source: {old!r}")
    return text + _OCCUPANCY if occupancy else text


def build(name: str, texts: dict, out: Path, include: Path = None) -> tuple:
    """``texts``: file name -> source; one library of them all."""
    srcs = []
    for fname, text in texts.items():
        src = out / f"{name}.{fname}"
        src.write_text(text)
        srcs.append(str(src))
    lib = out / f"{name}.so"
    cmd = ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           *(["-I", str(include)] if include else []), "-o", str(lib), *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    usage = [ln.strip() for ln in proc.stderr.splitlines()
             if "registers" in ln or "spill" in ln]
    return lib, usage


def sass_count(lib: Path, kernel: str) -> dict:
    """Instructions of the first function whose name contains ``kernel``
    in ``cuobjdump -sass``, and its ten commonest opcodes."""
    text = subprocess.run(["cuobjdump", "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    ops, inside = {}, False
    for ln in text.splitlines():
        if "Function :" in ln:
            if inside:
                break
            inside = kernel in ln
        elif inside:
            m = re.match(
                r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", ln)
            if m:
                op = m.group(1).split(".")[0]
                ops[op] = ops.get(op, 0) + 1
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"instructions": sum(ops.values()), "top": top}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("design", choices=["first", "redesign"])
    ap.add_argument("source", type=Path)
    ap.add_argument("--shape", type=int, nargs=4, default=[2, 2048, 8192, 16],
                    metavar=("BSZ", "S", "D", "N"))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--variants", nargs="+",
                    help="the variants to build and time (default: all)")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "scan_bwd_causes.json")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("scan_bwd_causes: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out = ROOT / "build" / "causes" / args.design
    out.mkdir(parents=True, exist_ok=True)
    if args.design == "first":
        text = args.source.read_text()
        jobs = {k: ({"ssm_scan_bwd.cu": patched(text, v)}, None)
                for k, v in VARIANTS.items()
                if k == "base" or not args.variants or k in args.variants}
    else:
        texts = {f: (args.source / f).read_text()
                 for f in ("ssm_scan.cu", "ssm_scan_bwd.cu")}
        jobs = {k: ({f: patched(text, v.get(f, []), f == "ssm_scan_bwd.cu")
                     for f, text in texts.items()}, args.source)
                for k, v in REDESIGN.items()
                if k == "base" or not args.variants or k in args.variants}
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda kv: build(kv[0], kv[1][0], out, kv[1][1]), jobs.items())))

    from repro_torch.models.layers import ParamSpec, init_param
    Bsz, S, D, N = args.shape
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    # dt and A as the model makes them (chip_smoke.phase_scan_grads)
    dt_bias = init_param(ParamSpec("smoke/dt_bias", (D,), "mamba_dt"), 0,
                         torch.float32, dev)
    A = -torch.exp(init_param(ParamSpec("smoke/A_log", (D, N), "mamba_A"), 0,
                              torch.float32, dev))
    x = torch.randn(Bsz, S, D, generator=gen, device=dev)
    dt = F.softplus(torch.randn(Bsz, S, D, generator=gen, device=dev)
                    + dt_bias)
    B = torch.randn(Bsz, S, N, generator=gen, device=dev)
    C = torch.randn(Bsz, S, N, generator=gen, device=dev)
    dy = torch.randn(Bsz, S, D, generator=gen, device=dev)
    first = args.design == "first"
    blocks = -(-D // (32 if first or N > 16 else 64))
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dB_part = torch.empty(blocks, Bsz, S, N, device=dev)
    dC_part = torch.empty_like(dB_part)
    dA_part = torch.empty(Bsz, D, N, device=dev)
    dh0 = torch.empty_like(dA_part)
    bounds = torch.empty(Bsz, -(-S // 16), D, N, device=dev)
    outs = (dx, ddt, dB_part, dC_part, dA_part, dh0)
    dB, dC, dA = torch.empty_like(B), torch.empty_like(C), torch.empty_like(A)
    y, h_final = torch.empty_like(x), torch.empty(Bsz, D, N, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    result = {"nvidia_smi": smi, "shape": args.shape, "variants": {}}
    base_bits = None
    for name, (path, usage) in built.items():
        lib = ctypes.CDLL(str(path))
        fn = lib.repro_ssm_scan_bwd_f32
        fn.argtypes = [P] * (15 if first else 17) + [I] * 5 + [P]
        fn.restype = I
        if not first:         # the variant's forward keeps its states
            cpb = 32 if name == "cpb32" else 64
            dB_part = torch.empty(-(-D // cpb), Bsz, S, N, device=dev)
            dC_part = torch.empty_like(dB_part)
            chunk = 8 if name == "ch8" else 16
            bounds = torch.empty(Bsz, -(-S // chunk), D, N, device=dev)
            fwd = lib.repro_ssm_scan_f32
            fwd.argtypes = [P] * 9 + [I] * 5 + [P]
            err = fwd(x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
                      A.data_ptr(), None, y.data_ptr(), h_final.data_ptr(),
                      bounds.data_ptr(), Bsz, S, D, N, 0, stream)
            if err:
                raise RuntimeError(f"{name}: forward failed, cudaError {err}")
        ptrs = ([t.data_ptr() for t in outs] + [bounds.data_ptr()] if first
                else [bounds.data_ptr(), dy.data_ptr(), None]
                + [t.data_ptr() for t in (dx, ddt, dB, dC, dA, dh0, dB_part,
                                          dC_part, dA_part)])

        def launch():
            head = [x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
                    A.data_ptr()]
            if first:
                head += [None, dy.data_ptr(), None]
            err = fn(*head, *ptrs, Bsz, S, D, N, 0, stream)
            if err:
                raise RuntimeError(f"{name}: launch failed, cudaError {err}")
        launch()
        torch.cuda.synchronize()
        bits = [t.clone() for t in (outs if first else
                                    (dx, ddt, dB, dC, dA, dh0))]
        if name == "base":
            base_bits = bits
        row = {"ms": ms(launch), "ptxas": usage,
               "blocks_per_sm": lib.probe_blocks_per_sm(4),
               "sass": sass_count(path, "ssm_scan_bwd_kernelILi4E")}
        if name == "no_pass1":
            row["same_bits_as_base"] = all(
                torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(bits, base_bits))
        result["variants"][name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
    if first:
        result["partial_sums_ms"] = ms(lambda: (
            dB_part.sum(0), dC_part.sum(0), dA_part.sum(0)))
    result["grid_blocks"] = blocks * Bsz
    result["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    base = result["variants"]["base"]["ms"]   # a run always has its base
    result["cost_ms"] = {k: base - v["ms"]
                         for k, v in result["variants"].items() if k != "base"}
    print("causes: " + json.dumps(result), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

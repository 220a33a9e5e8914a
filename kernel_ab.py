#!/usr/bin/env python3
"""Time the port's CUDA-core matmul, selective-scan (forward and backward) and
flash-attention kernels of two or more checkouts on one card, in turns, and
compare their outputs bit for bit.

    python3 kernel_ab.py parent=build/ab/parent change=. [--prefill [mamba] [dense]]
        [--kernels matmul ssm_scan ssm_scan_backward flash_attention]

Each ``NAME=DIR`` names the root of a checkout (its ``src/repro_torch``
builds its own kernels under ``DIR/build``).  The checkouts run in the order
of ``--order`` (default: the first, the second, the second, the first; for
an A/B of a parent and a change that is parent, change, change, parent),
each in a process of its own, so no two builds share a library.  In each
run, on the same seeded inputs:

- matmul (simt route): 4096^3 float32 (the Fig. 2 ``mul``), 1000x1531x777
  and 1000x1528x776 float32, 1000x1531x777 bf16;
- ssm_scan: ``chip_smoke.SCAN_SHAPES`` in float32 and bf16, with the model's
  dt and A;
- ssm_scan_backward: every ``chip_smoke.SCAN_GRAD_SHAPES`` row in float32,
  as ``chip_smoke.phase_scan_grads`` draws it: the wrapper's standalone
  call (``ms``: in a checkout whose forward kernel keeps states, the forward
  launch that makes them and the backward kernel), and, where the wrapper
  takes the forward's ``states``, the backward kernel given them
  (``ms_given_states``); each gradient's largest error against
  ``ref.ssm_scan_backward`` relative to its largest entry, and its SHA-256;
- flash_attention: every ``chip_smoke.FLASH_SHAPES`` row in float32 (the
  simt route) and in bf16 through the simt route (q, k, v one element past
  a 16-byte boundary), and qwen2-7b's long prefill in bf16 on the wgmma
  route;
- with ``--prefill``: 2048-token prefills at full width (parameters drawn on
  the card from seed 0), three times each: ``mamba`` (falcon-mamba-7b, what
  a bare ``--prefill`` runs) and ``dense`` (qwen2-7b at compute_dtype
  float32, with the flash kernel's own device time from CUDA events around
  its 28 launches).

Kernel times are CUDA-event means over ``chip_smoke.REPS`` launches after a
warm-up; each output's largest error against the plain version
(``kernels/ref.py``) is recorded, and its SHA-256 tells whether two
checkouts computed the same bits.  ``--kernels`` names the groups to run
(default: all four).  It prints the card's ``nvidia-smi`` name
and power limit, one JSON line per run and a summary line, and writes them
to ``--out`` (default ``build/kernel_ab.json``).  It needs a CUDA card and
imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# --prefill NAME -> (arch, compute dtype or None for the config's own)
PREFILLS = {"mamba": ("falcon-mamba-7b", None), "dense": ("qwen2-7b", "float32")}
GROUPS = ["matmul", "ssm_scan", "ssm_scan_backward", "flash_attention"]
MATMUL_SHAPES = [(4096, 4096, 4096, "float32"), (1000, 1531, 777, "float32"),
                 (1000, 1528, 776, "float32"), (1000, 1531, 777, "bfloat16")]

CHILD = r'''
import hashlib, json, sys, time
import torch
root, smoke_dir, matmul_shapes, prefill, groups = (
    sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), json.loads(sys.argv[4]),
    json.loads(sys.argv[5]))
sys.path.insert(0, root + "/src")
sys.path.insert(0, smoke_dir)
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.kernels import _build, matmul as mm, ref, ssm_scan as scan
t0 = time.perf_counter()
_build.library()
out = {"build_s": time.perf_counter() - t0, "build_dir": str(_build.build_dir())}

def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]

gen = torch.Generator(device="cuda").manual_seed(0)
out["matmul"] = []
for M, N, K, dname in matmul_shapes if "matmul" in groups else []:
    dtype = getattr(torch, dname)
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    y = torch.randn(K, N, generator=gen, device="cuda").to(dtype)
    got = mm.matmul(x, y)
    torch.cuda.synchronize()
    err = (got.float() - ref.matmul(x, y).float()).abs().max().item()
    out["matmul"].append({"shape": [M, N, K], "dtype": dname,
                          "max_err_over_sqrt_k": err / K ** 0.5,
                          "ms": cs.cuda_ms(torch, lambda: mm.matmul(x, y)),
                          "sha256": digest(got)})

import torch.nn.functional as F
from repro_torch.models.layers import ParamSpec, init_param
dev = torch.device("cuda")
gen = torch.Generator(device="cuda").manual_seed(0)
out["ssm_scan"] = []
for Bsz, S, D, N, with_h0 in cs.SCAN_SHAPES if "ssm_scan" in groups else []:
    # as chip_smoke.phase_scan_kernels draws them
    dt_bias = init_param(ParamSpec("smoke/dt_bias", (D,), "mamba_dt"), 0,
                         torch.float32, dev)
    A = -torch.exp(init_param(ParamSpec("smoke/A_log", (D, N), "mamba_A"), 0,
                              torch.float32, dev))
    x = torch.randn(Bsz, S, D, generator=gen, device=dev)
    dt = F.softplus(torch.randn(Bsz, S, D, generator=gen, device=dev)
                    + dt_bias)
    B = torch.randn(Bsz, S, N, generator=gen, device=dev)
    C = torch.randn(Bsz, S, N, generator=gen, device=dev)
    h0 = torch.randn(Bsz, D, N, generator=gen, device=dev) if with_h0 else None
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.to(dtype) for t in (x, dt, B, C)] + [A, h0]
        y, h = scan.ssm_scan(*args, return_state=True)
        want_y, want_h = ref.ssm_scan(*args, return_state=True)
        torch.cuda.synchronize()
        out["ssm_scan"].append({
            "shape": [Bsz, S, D, N], "h0": with_h0,
            "dtype": str(dtype).removeprefix("torch."),
            "max_abs_err_y": (y.float() - want_y.float()).abs().max().item(),
            "max_abs_err_h": (h - want_h).abs().max().item(),
            "ms": cs.cuda_ms(torch, lambda: scan.ssm_scan(
                *args, return_state=True)),
            "sha256_y": digest(y), "sha256_h": digest(h)})

# the backward kernel at every chip_smoke.SCAN_GRAD_SHAPES row, drawn as
# chip_smoke.phase_scan_grads draws it
import inspect
out["ssm_scan_backward"] = []
takes_states = "states" in inspect.signature(scan.ssm_scan_backward).parameters
gen = torch.Generator(device="cuda").manual_seed(3)
for Bsz, S, D, N, with_states in (cs.SCAN_GRAD_SHAPES
                                  if "ssm_scan_backward" in groups else []):
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
    h0, dh = ((torch.randn(Bsz, D, N, generator=gen, device=dev),
               torch.randn(Bsz, D, N, generator=gen, device=dev))
              if with_states else (None, None))
    args = (x, dt, B, C, A, h0, dy, dh)
    got = scan.ssm_scan_backward(*args)
    want = ref.ssm_scan_backward(*args)
    torch.cuda.synchronize()
    row = {"shape": [Bsz, S, D, N], "states": with_states,
           "dtype": "float32",
           "max_rel_err": max(
               ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
               if w.numel() else 0.0 for g, w in zip(got, want)),
           "ms": cs.cuda_ms(torch, lambda: scan.ssm_scan_backward(*args)),
           "ms_given_states": None}
    if takes_states:
        states = scan.ssm_scan(x, dt, B, C, A, h0, return_states=True)[2]
        row["ms_given_states"] = cs.cuda_ms(
            torch, lambda: scan.ssm_scan_backward(*args, states=states))
        del states
    for name, g in zip(cs.GRAD_NAMES, got):
        row["sha256_" + name] = digest(g)
    out["ssm_scan_backward"].append(row)
    del args, got, want, x, dt, B, C, dy, h0, dh

# flash attention at every chip_smoke.FLASH_SHAPES row: float32 (the simt
# route), bf16 through the simt route (q, k, v one element past a 16-byte
# boundary, which the wgmma route cannot take) and, at the long prefill,
# bf16 on the wgmma route (a check that it did not move)
from repro_torch.kernels import flash_attention as fa

out["flash_attention"] = []
for B, H, KH, Sq, Sk, Dh, causal in (cs.FLASH_SHAPES
                                    if "flash_attention" in groups else []):
    q = torch.randn(B, H, Sq, Dh, generator=gen, device=dev)
    k = torch.randn(B, KH, Sk, Dh, generator=gen, device=dev)
    v = torch.randn(B, KH, Sk, Dh, generator=gen, device=dev)
    cases = [("float32", "simt", (q, k, v)),
             ("bfloat16", "simt", tuple(cs._misaligned(torch, t.bfloat16())
                                        for t in (q, k, v)))]
    if Sq == cs.LONG_PROMPT:
        cases.append(("bfloat16", "wgmma",
                      tuple(t.bfloat16() for t in (q, k, v))))
    for dname, path, args in cases:
        before = fa.flash_attention.route_launches[path]
        o = fa.flash_attention(*args, causal=causal)
        want = ref.attention(*args, causal=causal)
        torch.cuda.synchronize()
        assert fa.flash_attention.route_launches[path] == before + 1, path
        out["flash_attention"].append({
            "shape": [B, H, KH, Sq, Sk, Dh], "causal": causal,
            "dtype": dname, "route": path,
            "max_abs_err": (o.float() - want.float()).abs().max().item(),
            "ms": cs.cuda_ms(torch, lambda: fa.flash_attention(
                *args, causal=causal)),
            "sha256": digest(o)})
        del o, want

def time_prefill(cfg, params):
    """Three 2048-token prefills: host seconds each (ending in a
    synchronize), the logits' digest, and the flash kernel's own device ms
    in the last (CUDA events around each of its launches)."""
    from repro_torch.models import transformer as TF
    prompt = torch.randint(1, cfg.vocab_size, (1, cs.LONG_PROMPT),
                           generator=torch.Generator(device="cuda").manual_seed(1),
                           device="cuda", dtype=torch.int32)
    step = TF.make_prefill_step(cfg, max_len=cs.LONG_MAX_LEN)
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, _ = step(params, prompt)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    res = {"arch": cfg.name, "compute_dtype": cfg.compute_dtype,
           "prompt_tokens": cs.LONG_PROMPT, "seconds": secs,
           "sha256_logits": digest(last)}
    if cs._path_kernel(cfg) == "flash_attention":
        with cs.timed_launches(torch, fa, "flash_attention") as events:
            step(params, prompt)
        res["flash_ms"] = cs.events_ms(torch, events)
        res["flash_launches"] = len(events)
    return res

if prefill:
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    out["prefill"] = []
    for arch, dtype in prefill:
        cfg = get_config(arch)
        if dtype:
            cfg = dataclasses.replace(cfg, compute_dtype=dtype)
        params = TF.init_params(cfg, 0, "cuda")
        out["prefill"].append(time_prefill(cfg, params))
        del params
        torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--order", help="comma-separated names (default: "
                    "first, second, second, first)")
    ap.add_argument("--prefill", nargs="*", choices=sorted(PREFILLS),
                    help="also time 2048-token prefills at full width: "
                    "`mamba` (falcon-mamba-7b, the default) and `dense` "
                    "(qwen2-7b at compute_dtype float32: the simt flash "
                    "route, with the flash kernel's own time)")
    ap.add_argument("--kernels", nargs="+", choices=GROUPS, default=GROUPS,
                    help="the kernel groups to run (default: all)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds for each run")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "kernel_ab.json",
                    help="where to write the runs and the summary as JSON")
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.trees)
    names = list(trees)
    order = (args.order.split(",") if args.order else
             [names[0], names[1], names[1], names[0]] if len(names) > 1
             else names)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    shapes = json.dumps([list(s) for s in MATMUL_SHAPES])
    prefills = ([] if args.prefill is None else
                [PREFILLS[p] for p in (args.prefill or ["mamba"])])
    runs = []
    for name in order:
        root = str((ROOT / trees[name]).resolve())
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, root, str(ROOT), shapes,
             json.dumps(prefills), json.dumps(args.kernels)],
            capture_output=True, text=True, timeout=args.timeout)
        result = next((json.loads(ln[7:]) for ln in proc.stdout.splitlines()
                       if ln.startswith("RESULT ")), None)
        if proc.returncode != 0 or result is None:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"run of {name} ({root}) failed with exit "
                               f"code {proc.returncode}")
        result.update(name=name, wall_s=time.perf_counter() - t0)
        runs.append(result)
        print(f"run {name}: {json.dumps(result)}", flush=True)

    def rows(key):
        """Per case: each run's time, and whether all runs' bits agree."""
        out = []
        for i, case in enumerate(runs[0][key]):
            row = {k: case[k] for k in ("shape", "dtype", "h0", "states",
                                        "causal", "route") if k in case}
            for k in case:
                if k.startswith("ms") or k.startswith("max_"):
                    row[k] = {}
                    for r in runs:
                        row[k].setdefault(r["name"], []).append(r[key][i][k])
            hashes = [k for k in case if k.startswith("sha256")]
            row["bits_equal"] = {
                h: len({r[key][i][h] for r in runs}) == 1 for h in hashes}
            out.append(row)
        return out

    summary = {"nvidia_smi": smi, "order": order,
               **{key: rows(key) for key in GROUPS}}
    for i, (arch, dtype) in enumerate(prefills):
        entry = {"arch": arch, "compute_dtype": dtype, "seconds": {},
                 "flash_ms": {}, "logits_bits_equal": len(
                     {r["prefill"][i]["sha256_logits"] for r in runs}) == 1}
        for r in runs:
            got = r["prefill"][i]
            entry["seconds"].setdefault(r["name"], []).append(got["seconds"])
            if "flash_ms" in got:
                entry["flash_ms"].setdefault(r["name"], []).append(
                    got["flash_ms"])
        summary.setdefault("prefill", []).append(entry)
    print("summary: " + json.dumps(summary), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"summary": summary, "runs": runs},
                                   indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

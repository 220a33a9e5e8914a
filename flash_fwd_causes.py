#!/usr/bin/env python3
"""Measure what holds the wgmma flash-attention forward: build variants of
its source, each with one part of its design taken out or one cost
changed, and time each on one card.

    python3 flash_fwd_causes.py [--variants ftz no_pingpong n64_pv]

Each variant is a copy of ``src/repro_torch`` under ``build/causes/NAME``
with text patches on ``csrc/flash_attention_wgmma.cu`` (a patch that no
longer matches the source raises):

- ``base``: as it is;
- ``ftz``: the probabilities' ``exp2f`` replaced by a bare
  ``ex2.approx.ftz`` (no guard of exponents below -126; such a result is
  flushed to zero, so the kernel's bits may move where one occurs);
- ``no_pingpong``: the two consumers' turns on named barriers removed (each
  issues its products when its data is there);
- ``n64_pv``: P V as two m64n64k16 products a k16 step at D > 64, one a
  64-wide box of V, as the earlier kernel issued them.

Each variant runs in a process of its own, which builds its own library
(under its tree's ``build/``), in the order base, variants, variants
reversed, base.  At every bf16 ``chip_smoke.FLASH_SHAPES`` row with at
least 448 queries it times the kernel without lse (CUDA-event mean of
``--reps`` launches after a warm-up) and hashes out and lse, so each
variant's line says whether it kept base's bits.  It prints the card's
``nvidia-smi`` name and power limit, each build's ``-Xptxas -v`` registers,
spills and C75xx notes, one line a shape and one JSON line, also written
to ``--out``.  It needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "kernels/csrc/flash_attention_wgmma.cu"
_EX2 = """__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {"""
# variant -> [(old, new)], each old text replaced everywhere it occurs
VARIANTS = {
    "base": [],
    "ftz": [("__device__ __forceinline__ float quad_max(float v) {", _EX2),
            ("sc[4 * j + e] = exp2f(sc[4 * j + e] - mu_a);",
             "sc[4 * j + e] = ex2_ftz(sc[4 * j + e] - mu_a);"),
            ("sc[4 * j + 2 + e] = exp2f(sc[4 * j + 2 + e] - mu_b);",
             "sc[4 * j + 2 + e] = ex2_ftz(sc[4 * j + 2 + e] - mu_b);")],
    "no_pingpong": [
        ("named_bar_sync(my_turn, CONSUMERS * 128);", ""),
        ("named_bar_arrive(other_turn, CONSUMERS * 128);", ""),
        ("if (wg == 1) named_bar_arrive(1, CONSUMERS * 128);", "")],
    "n64_pv": [("""    if constexpr (ND == 2) {
      wgmma_rs_m64n128k16<1>(o, p[kk], vd);
    } else {""", """    if constexpr (ND == 2) {
      float (&lo)[32] = *reinterpret_cast<float (*)[32]>(&o[0]);
      float (&hi)[32] = *reinterpret_cast<float (*)[32]>(&o[32]);
      wgmma_rs_m64n64k16<1>(lo, p[kk], vd);
      wgmma_rs_m64n64k16<1>(
          hi, p[kk],
          desc_sw128(v_addr + BOX_BYTES + 2048 * kk, BOX_BYTES,
                     kSwizzleAtom));
    } else {""")],
}

CHILD = r'''
import hashlib, json, re, sys
import torch
sys.path.insert(0, sys.argv[1] + "/src")
sys.path.insert(0, sys.argv[2])
import chip_smoke as cs
from repro_torch.kernels import _build, flash_attention as fa
torch.backends.cuda.matmul.allow_tf32 = False
_build.library()
sec = [s for s in _build.ptxas_report().split("== ")
       if s.startswith("flash_attention_wgmma.cu")][0]
info = {"registers": re.findall(r"Used (\d+) registers", sec),
        "spill_stores": re.findall(r"(\d+) bytes spill stores", sec),
        "notes": sorted(set(re.findall(r"C75\d\d", sec)))}

def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]

gen = torch.Generator(device="cuda").manual_seed(0)
rows = []
for B, H, KH, Sq, Sk, D, causal in cs.FLASH_SHAPES:
    if Sq < 448:
        continue
    q = torch.randn(B, H, Sq, D, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, KH, Sk, D, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, KH, Sk, D, generator=gen, device="cuda").bfloat16()
    assert fa.route(q.dtype, D) == "wgmma"
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    rows.append({"shape": [B, H, KH, Sq, Sk, D], "causal": causal,
                 "sha256": digest(out, lse),
                 "ms": cs.cuda_ms(torch, lambda: fa.flash_attention(
                     q, k, v, causal=causal), reps=int(sys.argv[3]))})
print("RESULT " + json.dumps({"build": info, "rows": rows}))
'''


def make_tree(name: str) -> Path:
    """``build/causes/NAME``: a copy of ``src/repro_torch`` with the
    variant's patches."""
    dst = ROOT / "build" / "causes" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = dst / "src" / "repro_torch" / SOURCE
    text = path.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise ValueError(f"variant {name}: patch no longer matches "
                             f"{SOURCE}: {old[:60]!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS)[1:],
                    choices=list(VARIANTS)[1:])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--timeout", type=float, default=400.0,
                    help="seconds for each run")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "flash_fwd_causes.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_fwd_causes: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    names = ["base", *args.variants]
    trees = {n: make_tree(n) for n in names}
    order = names + names[::-1]
    runs = {}
    for name in order:
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, str(trees[name]), str(ROOT),
             str(args.reps)], capture_output=True, text=True,
            timeout=args.timeout)
        result = next((json.loads(ln[7:]) for ln in proc.stdout.splitlines()
                       if ln.startswith("RESULT ")), None)
        if proc.returncode != 0 or result is None:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            raise RuntimeError(f"run of {name} failed with exit code "
                               f"{proc.returncode}")
        print(f"{name}: build {json.dumps(result['build'])}", flush=True)
        runs.setdefault(name, []).append(result)
    summary = []
    for i, row in enumerate(runs["base"][0]["rows"]):
        entry = {"shape": row["shape"], "causal": row["causal"]}
        for n in names:
            entry[n] = {"ms": [r["rows"][i]["ms"] for r in runs[n]],
                        "base_bits": all(r["rows"][i]["sha256"] ==
                                         row["sha256"] for r in runs[n])}
        summary.append(entry)
        print(f"{row['shape']} " + " | ".join(
            f"{n} " + "/".join(f"{m:.4f}" for m in entry[n]["ms"]) +
            ("" if entry[n]["base_bits"] else " (bits moved)")
            for n in names), flush=True)
    line = {"nvidia_smi": smi, "order": order, "rows": summary,
            "builds": {n: runs[n][0]["build"] for n in names}}
    print(json.dumps(line), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(line, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

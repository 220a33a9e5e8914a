#!/usr/bin/env python3
"""Measure what each part of the wgmma matmul's design is worth: build
variants of it, each with one part taken out, and time and hash each on
one card.

    python3 matmul_causes.py [--variants no_persistence no_tma_store ...]

Each variant is a copy of ``src/repro_torch`` under ``build/causes/NAME``
with text patches on ``kernels/csrc/matmul_wgmma.cu`` or the plan in
``kernels/matmul.py`` (a patch that no longer matches raises):

- ``base``: as it is;
- ``no_persistence``: one block a tile (the plan's block count is the
  tile count), so no tile's loads overlap another's products or epilogue;
- ``no_tma_store``: the epilogue as plain 4-byte stores from registers,
  masked at M and N, in place of the staging tile and TMA's store;
- ``no_raster``: tiles in plain row-major order (raster group 1);
- ``no_tile_choice``: 128x256 tiles at every shape;
- ``n128_pairs``: two m64n128k16 products a 16-deep step at BN 256, as the
  kernel before the redesign issued them, in place of one m64n256k16;
- ``stages3_full``: the other budget at BN 256: 3 stages and the whole
  64 x 256 sum of a consumer staged at once (one epilogue round), in place
  of 4 stages and two rounds of 128 columns.

Each variant runs in a process of its own, which builds its own library
(under its tree's ``build/``), in the order base, variants, variants
reversed, base.  At each of ``SHAPES`` in bf16 it times the kernel
(CUDA-event mean of ``--reps`` launches after a warm-up, and the device
time under ``torch.profiler``, ``chip_smoke.device_busy_ms``) and hashes
its output, so each variant's line says whether it kept base's bits.  It
prints the card's ``nvidia-smi`` name and power limit, each build's
``-Xptxas -v`` registers, spills and C75xx notes, one line a shape and one
JSON line, also written to ``--out``.  It needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL = "kernels/csrc/matmul_wgmma.cu"
PLAN = "kernels/matmul.py"
# the two shapes of PERF.md's table; then those at which clusters of two
# blocks on tiles one above the other were measured and taken out
# (PERF.md §6): M <= 128 (one row of tiles) at 32 and at 74 tiles, and an
# odd count of tile rows (33)
SHAPES = [(4096, 4096, 4096), (1000, 1528, 776), (8, 4096, 4096),
          (128, 18944, 3584), (4104, 4096, 4096)]

_PLAIN_EPILOGUE = """    // plain stores from registers, masked at M and N
    const int row = tm * BM + wg * 64 + ra;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = tn * BN + 8 * j + 2 * (lane % 4);   // c, c + 1; N even
      if (c >= N) continue;
      if (row < M) {
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * N + c) =
            pack_bf16(acc[4 * j], acc[4 * j + 1]);
      }
      if (row + 8 < M) {
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row + 8) * N +
                                     c) = pack_bf16(acc[4 * j + 2],
                                                    acc[4 * j + 3]);
      }
    }
  }
}
"""
# variant -> [(file, old, new)], each old text replaced everywhere it occurs
VARIANTS = {
    "base": [],
    "no_persistence": [
        (PLAN, "blocks = min(tiles_m * tiles_n, resident)",
         "blocks = tiles_m * tiles_n")],
    "no_tma_store": [
        (KERNEL, "omap, int M,\n",
         "omap,\n                        __nv_bfloat16* __restrict__ out, int M,\n"),
        (KERNEL, "const CUtensorMap& omap, int M,",
         "const CUtensorMap& omap, void* out, int M,"),
        (KERNEL, "omap, M, N, K, tiles_m, tiles_n, group);",
         "omap, static_cast<__nv_bfloat16*>(out), M, N, K, tiles_m, "
         "tiles_n, group);"),
        (KERNEL, "(xmap, ymap, omap, M, N, K, tm, tn,",
         "(xmap, ymap, omap, out, M, N, K, tm, tn,"),
        (KERNEL, "    // epilogue: BN / EPI_COLS rounds through the staging tile\n",
         _PLAIN_EPILOGUE + "\n#if 0\n"),
        (KERNEL, "  if (leader) bulk_wait<0>();   // out is written before the "
                 "block ends\n}\n",
         "#endif\n"),
    ],
    "no_raster": [
        (PLAN, "return Plan(tile_n, blocks, group, tiles_m, tiles_n)",
         "return Plan(tile_n, blocks, 1, tiles_m, tiles_n)")],
    "no_tile_choice": [
        (PLAN, "tile_n = min(TILE_NS, key=waves_work)", "tile_n = 256")],
    "n128_pairs": [
        (KERNEL, """    wgmma_ss_m64n256k16<1>(acc, da, desc_sw128(b, BOX_BYTES, kSwizzleAtom),
                           1);""",
         """    float (&lo)[64] = *reinterpret_cast<float (*)[64]>(&acc[0]);
    float (&hi)[64] = *reinterpret_cast<float (*)[64]>(&acc[64]);
    wgmma_ss_m64n128k16<1>(lo, da, desc_sw128(b, BOX_BYTES, kSwizzleAtom),
                           1);
    wgmma_ss_m64n128k16<1>(
        hi, da, desc_sw128(b + 2 * BOX_BYTES, BOX_BYTES, kSwizzleAtom), 1);""")],
    "stages3_full": [
        (KERNEL, "static constexpr int STAGES = 4, EPI_COLS = 128;",
         "static constexpr int STAGES = 3, EPI_COLS = 256;")],
}

CHILD = r'''
import hashlib, json, re, sys
import torch
sys.path.insert(0, sys.argv[1] + "/src")
sys.path.insert(0, sys.argv[2])
import chip_smoke as cs
from repro_torch.kernels import _build, matmul as mm
_build.library()
sec = [s for s in _build.ptxas_report().split("== ")
       if s.startswith("matmul_wgmma.cu")][0]
info = {"registers": re.findall(r"Used (\d+) registers", sec),
        "spill_stores": re.findall(r"(\d+) bytes spill stores", sec),
        "notes": sorted(set(re.findall(r"C75\d\d", sec)))}

def digest(t):
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]

gen = torch.Generator(device="cuda").manual_seed(0)
rows = []
for M, N, K in json.loads(sys.argv[4]):
    x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    y = torch.randn(K, N, generator=gen, device="cuda").bfloat16()
    assert mm.route(x.dtype, N, K) == "wgmma"
    out = mm.matmul(x, y)
    p = mm.plan(M, N, mm.resident_blocks(x.device.index))
    rows.append({"shape": [M, N, K], "sha256": digest(out),
                 "plan": [p.tile_n, p.blocks, p.group],
                 "ms": cs.cuda_ms(torch, lambda: mm.matmul(x, y),
                                  reps=int(sys.argv[3])),
                 "ms_device": cs.device_busy_ms(torch,
                                                lambda: mm.matmul(x, y))})
print("RESULT " + json.dumps({"build": info, "rows": rows}))
'''


def make_tree(name: str) -> Path:
    """``build/causes/NAME``: a copy of ``src/repro_torch`` with the
    variant's patches."""
    dst = ROOT / "build" / "causes" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in VARIANTS[name]:
        path = dst / "src" / "repro_torch" / rel
        text = path.read_text()
        if old not in text:
            raise ValueError(f"variant {name}: patch no longer matches "
                             f"{rel}: {old[:60]!r}")
        path.write_text(text.replace(old, new))
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS)[1:],
                    choices=list(VARIANTS)[1:])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds for each run")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "matmul_causes.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("matmul_causes: no CUDA device is available", file=sys.stderr)
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
             str(args.reps), json.dumps(SHAPES)], capture_output=True,
            text=True, timeout=args.timeout)
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
        entry = {"shape": row["shape"]}
        for n in names:
            got = [r["rows"][i] for r in runs[n]]
            entry[n] = {"plan": got[0]["plan"],
                        "ms": [g["ms"] for g in got],
                        "ms_device": [g["ms_device"] for g in got],
                        "base_bits": all(g["sha256"] == row["sha256"]
                                         for g in got)}
        summary.append(entry)
        print(f"{row['shape']} " + " | ".join(
            f"{n} " + "/".join(f"{m:.4f}" for m in entry[n]["ms"]) +
            " device " + "/".join(f"{m:.4f}" for m in entry[n]["ms_device"]) +
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

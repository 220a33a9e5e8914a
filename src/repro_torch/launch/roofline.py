"""Roofline analysis of the dry-run's records, at H100 constants.

Port of ``benchmarks/roofline.py``.  Reads every
``<dir>/<arch>__<shape>__<mesh>[_tag].json`` that
:mod:`repro_torch.launch.dryrun` writes (``results/dryrun_torch`` from the
repo root by default) and derives, per cell:

  compute term    = Σ_dtype FLOPs_per_device(dtype) / peak(dtype)    [s]
                    (float32 products at the CUDA cores' 67 TFLOP/s,
                     bf16 at the tensor cores' 989)
  memory term     = bytes_per_device / HBM bandwidth (3.35 TB/s)     [s]
  collective term = wire_nvlink / 450 GB/s + wire_ib / 50 GB/s       [s]
                    (per-device wire bytes, ring-algorithm factors, each
                     group inside one node of 8 or across nodes)

plus MODEL_FLOPS = 6·N(_active)·D (train) or 2·N_active·D (inference),
the useful-compute ratio MODEL_FLOPS/FLOPs, the dominant term, the MFU
bound (the model's FLOPs at the bf16 peak over the largest term), whether
the peak memory fits the card, and a one-line lever.  These are estimates
at data-sheet constants, not measurements: the bytes are eager execution's
(each operation's inputs and outputs), not what the caches save.

Run ``PYTHONPATH=src python -m repro_torch.launch.roofline`` from the repo
root; ``--markdown`` prints the single-mesh table as markdown.
"""
from __future__ import annotations

import argparse
import csv
import functools
import glob
import json
import os
from typing import Any, Dict, List, Optional, Sequence

from .costs import HBM_BYTES, HBM_BYTES_PER_S, PEAK_FLOPS, compute_seconds
from .dryrun import DEFAULT_OUT, collective_seconds

DRYRUN_DIR = DEFAULT_OUT
RESULTS_DIR = "results"


@functools.lru_cache(maxsize=None)
def _param_counts(arch: str):
    """(total, active) parameter counts, from the parameter specs: nothing
    is allocated."""
    from ..configs import get_config
    from ..models import encdec as ED
    from ..models import transformer as TF
    cfg = get_config(arch)
    if cfg.is_encoder_decoder:
        n = ED.count_params(cfg)
        return n, n
    return TF.count_params(cfg), TF.count_active_params(cfg)


def _shape(shape):
    from ..models.config import SHAPES
    return SHAPES[shape] if isinstance(shape, str) else shape


def _tokens_per_step(shape) -> int:
    s = _shape(shape)
    if s.kind in ("train", "prefill"):
        return s.seq_len * s.global_batch
    return s.global_batch              # decode: one token per sequence


def model_flops(arch: str, shape) -> float:
    total, active = _param_counts(arch)
    D = _tokens_per_step(shape)
    mult = 6.0 if _shape(shape).kind == "train" else 2.0
    return mult * active * D


def _record_shape(rec: Dict):
    if "shape_spec" in rec:
        from ..models.config import ShapeSpec
        return ShapeSpec(**rec["shape_spec"])
    return rec["shape"]


def analyse_record(rec: Dict) -> Optional[Dict]:
    """The roofline row of one dry-run record (None unless it is OK).  The
    record's top-level counts are the exact full-depth ones; its
    ``corrected`` probe extrapolation is only a check of them."""
    if rec.get("status") != "OK":
        return None
    chips = rec["chips"]
    flops_dev = rec["flops_per_device"]
    by_dtype = rec.get("flops_by_dtype") or {"bfloat16": flops_dev}
    t_comp = compute_seconds(by_dtype)
    t_mem = rec["bytes_per_device"] / HBM_BYTES_PER_S
    coll = rec.get("collectives", {})
    t_coll = collective_seconds(coll)
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())

    mf = model_flops(rec["arch"], _record_shape(rec))
    mf_dev = mf / chips
    useful_ratio = mf_dev / flops_dev if flops_dev else 0.0
    t_model = mf_dev / PEAK_FLOPS["bfloat16"]
    mfu_bound = t_model / bound if bound > 0 else 0.0
    f32_share = (by_dtype.get("float32", 0.0) / PEAK_FLOPS["float32"]
                 / t_comp if t_comp else 0.0)

    peak = rec.get("peak_memory_in_bytes", 0)
    raw = {k: v for k, v in coll.items() if not k.startswith("_")}
    big_coll = max(raw, key=raw.get) if raw else "-"

    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "tag": rec.get("tag", ""),
        "chips": chips,
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": bound,
        "mfu_bound": mfu_bound,
        "useful_flops_ratio": useful_ratio,
        "f32_compute_share": f32_share,
        "mem_gib_per_dev": peak / 1024 ** 3,
        "fits_hbm": peak < HBM_BYTES,
        "top_collective": big_coll,
        "lever": lever(dominant, rec, useful_ratio, big_coll, f32_share),
    }


def lever(dominant: str, rec: Dict, useful_ratio: float,
          big_coll: str, f32_share: float = 0.0) -> str:
    kind = rec["shape"].split("_")[0]
    if dominant == "compute":
        if f32_share > 0.5:
            return (f"float32 products on the CUDA cores take "
                    f"{f32_share:.0%} of the compute term; run them in bf16 "
                    f"on the tensor cores (the unembedding, the attention "
                    f"backward)")
        if useful_ratio < 0.55 and kind == "train":
            return ("recompute and replicated work inflate FLOPs "
                    f"(useful={useful_ratio:.0%}); relax the checkpoint "
                    f"policy, shard what every rank repeats")
        return ("compute-bound near useful FLOPs; raise arithmetic "
                "intensity per chip (larger per-chip tile)")
    if dominant == "memory":
        if kind in ("decode", "long"):
            return ("decode is HBM-bound on weights+KV reads; quantize KV / "
                    "shard cache over more axes / batch more requests")
        return ("HBM-bound: fuse elementwise chains, avoid f32 spills, "
                "check layout transposes")
    return (f"collective-bound (top: {big_coll}); reshard to cut it or "
            f"overlap with compute")


def _records(path: str) -> List[Dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(path, "*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def load_cells(mesh: str = "single", tag: str = "",
               path: str = DRYRUN_DIR) -> List[Dict]:
    rows = []
    for rec in _records(path):
        if rec.get("mesh") != mesh or rec.get("tag", "") != tag:
            continue
        row = analyse_record(rec)
        if row:
            rows.append(row)
    return rows


def skip_cells(mesh: str = "single", path: str = DRYRUN_DIR) -> List[Dict]:
    rows = []
    for rec in _records(path):
        if rec.get("mesh") != mesh or rec.get("status") != "SKIP":
            continue
        if rec.get("tag", ""):
            continue
        rows.append({"arch": rec["arch"], "shape": rec["shape"],
                     "reason": rec["reason"][:70]})
    return rows


def to_markdown(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | Tcomp (ms) | Tmem (ms) | Tcoll (ms) | dominant "
           "| MFU-bound | useful | peak GiB | lever |")
    sep = "|" + "---|" * 10
    out = [hdr, sep]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']*1e3:.2f} "
            f"| {r['t_memory_s']*1e3:.2f} | {r['t_collective_s']*1e3:.2f} "
            f"| **{r['dominant']}** | {r['mfu_bound']:.1%} "
            f"| {r['useful_flops_ratio']:.0%} "
            f"| {r['mem_gib_per_dev']:.1f}{'' if r['fits_hbm'] else ' ✗'} "
            f"| {r['lever']} |")
    return "\n".join(out)


def write_csv(name: str, rows: List[Dict[str, Any]]) -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, f"{name}.csv")
    if not rows:
        return path
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    return path


def print_rows(title: str, rows: Sequence[Dict[str, Any]]) -> None:
    print(f"\n== {title} ==")
    if not rows:
        print("(no rows)")
        return
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    print(",".join(keys))
    for r in rows:
        print(",".join(_fmt(r.get(k, "")) for k in keys))


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=DRYRUN_DIR,
                    help="the dry-run's records")
    ap.add_argument("--markdown", action="store_true",
                    help="also print the single-mesh table as markdown")
    args = ap.parse_args(argv)
    rows = load_cells("single", path=args.dir)
    write_csv("roofline_torch_single", rows)
    slim = [{k: v for k, v in r.items()
             if k in ("arch", "shape", "t_compute_s", "t_memory_s",
                      "t_collective_s", "dominant", "mfu_bound",
                      "useful_flops_ratio", "f32_compute_share",
                      "mem_gib_per_dev", "fits_hbm")} for r in rows]
    print_rows("Roofline (single 256-GPU mesh, H100 data-sheet constants; "
               "estimates, not measurements)", slim)
    skips = skip_cells("single", path=args.dir)
    if skips:
        print_rows("Skipped cells", skips)
    multi = load_cells("multi", path=args.dir)
    if multi:
        write_csv("roofline_torch_multi", multi)
        sl = [{k: v for k, v in r.items()
               if k in ("arch", "shape", "t_collective_s", "dominant")}
              for r in multi]
        print_rows("Multi 512-GPU mesh: collective view", sl)
    if args.markdown:
        print()
        print(to_markdown(rows))
    return rows


if __name__ == "__main__":
    main()

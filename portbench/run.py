"""Run one cell of the PyTorch port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration file and its traffic mix are found by name
through ``BENCHMARK.json``.  The run draws its weights and batches from
``--seed``, sets up, measures for ``--seconds``, checks the steps it
trained against the plain reference, and prints one JSON line last: the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``.  Without a card, or in a checkout without the port, it
exits non-zero and prints no result; so it does if the process has loaded
JAX or the JAX package by the time the window has closed.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from portbench import harness
    started = harness.process_start()
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        return harness.fail("this checkout has no src/repro_torch to run")
    harness.keep_caches_in_checkout()
    cell = harness.cell(harness.benchmark(), args.workload)

    import torch
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return harness.fail(f"{args.workload} needs {chips} CUDA device(s); "
                            f"this machine has "
                            f"{torch.cuda.device_count()}", code=3)
    driver = harness.driver(cell["traffic"]["kind"])
    result = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda", started)
    foreign = harness.foreign_modules()
    if foreign:
        return harness.fail(f"the run loaded {foreign}")
    return report(cell, result, bool(args.trace), torch)


def report(cell, result, traced: bool, torch) -> int:
    from portbench import compare, harness
    checks = compare.judge(result["numbers"],
                           compare.limits(cell["workload"]["name"]))
    device = {**harness.card(torch),
              "memory_peak_bytes": result["peak_bytes"]}
    line = {"correct": all(c["ok"] for c in checks.values()),
            "attempted": result["attempted"], "failed": result["failed"],
            "metrics": harness.driver(cell["traffic"]["kind"]).metrics(
                cell, result, traced),
            "device": device, "window": result["window"]}
    if traced:
        rec = result["trace"]
        device["busy_s"] = rec.busy_us / 1e6
        device["window_s"] = rec.window_us / 1e6
        line["breakdown"] = rec.breakdown
    harness.emit(line, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())

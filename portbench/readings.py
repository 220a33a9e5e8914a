"""The readings a cell's limits are set from, on the card, in one process:

    python3 portbench/readings.py --workload <cell> --seeds 1 2 ... \\
        [--control-seeds ...] [--fault-seeds ...] [--out FILE]

For each seed, the program's compared steps and the reference's, and the
three numbers of ``compare.py`` (the lower readings).  For each control
seed, the control (the reference computed with fp8 operands, in the
program's place) against the reference (the upper readings).  For each
fault seed, each fault of ``faults.py`` planted in the program.  Prints one
JSON line per reading and writes them all to ``--out``.  The benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the faults whose readings set a limit's upper end (faults.py)
LIMITING = ("state_unchanged", "half_batch", "kernel_grad_doubled")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=list(LIMITING))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from portbench import compare, faults, harness
    harness.keep_caches_in_checkout()
    import torch
    if not torch.cuda.is_available():
        return harness.fail("no CUDA device")
    cell = harness.cell(harness.benchmark(), args.workload)
    drv = harness.driver(cell["traffic"]["kind"])
    dev = torch.device("cuda")
    out = []

    def emit(**rec):
        rec["card"] = harness.card(torch)["nvidia_smi"]
        print(json.dumps(rec), flush=True)
        out.append(rec)

    refs = {}

    def reference(seed):
        if seed not in refs:
            t0 = time.perf_counter()
            refs[seed] = drv.follow(cell, seed, dev)
            emit(kind="reference", seed=seed,
                 seconds=time.perf_counter() - t0,
                 losses=refs[seed]["losses"])
        return refs[seed]

    def program(seed, fault=None):
        import contextlib
        with (faults.FAULTS[fault]() if fault else contextlib.nullcontext()):
            opt, step = drv.build(cell, dev)
            t0 = time.perf_counter()
            params, state, prog = drv.first_steps(cell, opt, step, seed, dev)
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            del params, state, step, opt
        drv.free(torch, True)
        torch.cuda.reset_peak_memory_stats()
        return prog, seconds, peak

    for seed in args.seeds:
        prog, seconds, peak = program(seed)
        ref = reference(seed)
        emit(kind="program", seed=seed, seconds=seconds, peak_bytes=peak,
             losses=prog["losses"], numbers=compare.numbers(prog, ref),
             leaves=leaves(prog, ref))
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        ctl = drv.follow(cell, seed, dev, precision="fp8")
        seconds = time.perf_counter() - t0
        drv.free(torch, True)
        ref = reference(seed)
        emit(kind="control", seed=seed, seconds=seconds,
             losses=ctl["losses"], numbers=compare.numbers(ctl, ref),
             leaves=leaves(ctl, ref))
    for seed in args.fault_seeds:
        for fault in args.faults:
            prog, seconds, _ = program(seed, fault)
            ref = reference(seed)
            emit(kind=f"fault:{fault}", seed=seed, seconds=seconds,
                 losses=prog["losses"], numbers=compare.numbers(prog, ref),
                 leaves=leaves(prog, ref))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def leaves(prog, ref):
    """Each leaf's first-gradient and change norms, program's then
    reference's."""
    return {p: [prog["first_grad"][p], ref["first_grad"][p],
                prog["change"][p], ref["change"][p]]
            for p in ref["first_grad"]}


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the cluster paths of ``chip_smoke.py`` in two or more checkouts on one
card, in turns: phase 4 (the Fig. 2 DAG, sequential and threaded), phase 4b
(the same DAG on the cluster runtime's spawned workers, three runs) and
phase 4c (through the gateway: a cold job that starts the pool, then warm
jobs on it).

    python3 cluster_ab.py parent=build/ab/parent change=. [--order NAME ...]

Each ``NAME=DIR`` names the root of a checkout.  Each run is a process of
its own that imports ``DIR/chip_smoke.py`` and calls its phase functions
(device, build, kernels, 4, 4b, 4c) with ``DIR/src`` first on the path, so
the workers it spawns load that checkout's ``repro_torch``.  The checkouts
run in the order of ``--order`` (default: the first, the second, the
second, the first; for a parent and a change, parent, change, change,
parent).  Each run's output goes to ``chiprun_out/cluster_ab/`` and its
walls are printed: phase 4's sequential and threaded walls, each 4b run's
wall and first completed task, and each 4c job's client wall.  The last
line is one JSON object of every run's walls.  Needs one card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "cluster_ab"
RUN_TIMEOUT_S = 900


def run_phases(root: Path) -> None:
    """In the child: ``root``'s chip_smoke phases up to 4c."""
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import torch
    import chip_smoke as cs
    if Path(cs.__file__).resolve().parent != root:
        raise RuntimeError(f"imported {cs.__file__}, not {root}'s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_device(torch)
    cs.phase_build()
    checks = cs.phase_kernels(torch)
    _, graph, seq = cs.phase_main_path(torch, checks)
    cs.phase_process_path(torch, graph, seq)
    cs.phase_gateway_path(torch, graph, seq)


def walls(text: str) -> dict:
    """The walls of one run's output lines."""
    got = {"process": [], "gateway": []}
    for ln in text.splitlines():
        tag, _, payload = ln.partition(": ")
        if tag not in ("main_path", "process_path", "gateway_path"):
            continue
        d = json.loads(payload)
        if tag == "main_path":
            got["seq_wall_s"] = d["seq_wall_s"]
            got["threaded_wall_s"] = d["threaded_wall_s"]
        elif tag == "process_path":
            got["process"].append({
                "fuse": d["fuse"], "fail_worker": d["fail_worker"],
                "wall_s": d["wall_s"], "first_done_s": d["first_done_s"]})
        else:
            got["gateway"].append({"run": d["run"], "tenant": d["tenant"],
                                   "client_wall_s": d["client_wall_s"]})
    return got


def main(argv) -> int:
    if argv[:1] == ["--run"]:
        run_phases(Path(argv[1]).resolve())
        return 0
    order = None
    if "--order" in argv:
        i = argv.index("--order")
        order, argv = argv[i + 1:], argv[:i]
    trees = dict(a.split("=", 1) for a in argv)
    if len(trees) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    names = list(trees)
    order = order or [names[0], names[1], names[1], names[0]]
    OUT.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, name in enumerate(order):
        root = Path(trees[name]).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--run",
             str(root)], cwd=str(root), env=env, capture_output=True,
            text=True, timeout=RUN_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        (OUT / f"{i}_{name}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode:
            print(proc.stdout[-3000:] + proc.stderr[-3000:], file=sys.stderr)
            print(f"cluster_ab: run {i} ({name}) exited "
                  f"{proc.returncode}", file=sys.stderr)
            return 1
        if i == 0:
            print(proc.stdout.splitlines()[0], flush=True)  # name, limit
        w = walls(proc.stdout)
        runs.append({"name": name, "run": i, "seconds": seconds, **w})
        print(f"{i} {name}: seq {w['seq_wall_s']:.3f} s, threaded "
              f"{w['threaded_wall_s']:.3f} s | 4b wall "
              + " / ".join(f"{p['wall_s']:.3f}" for p in w["process"])
              + " s, first done "
              + " / ".join(f"{p['first_done_s']:.3f}" for p in w["process"])
              + " s | 4c client "
              + " / ".join(f"{g['run']} {g['client_wall_s']:.3f}"
                           for g in w["gateway"]) + " s", flush=True)
    print(json.dumps({"runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Quickstart on the PyTorch port — the paper's interface in 60 lines.

``examples/quickstart.py`` on ``repro_torch.core``: mark coarse functions
with ``@task`` / ``@io_task``, write a plain Python driver, and the
auto-parallelizer traces it into a data-dependency DAG, schedules tasks
greedily as their inputs become ready, and executes them on a
work-stealing worker pool, while IO stays in program order via
RealWorld-token edges.  The task values are tensors on ``--device``: the
CUDA card unless another device is named (without a card it raises unless
``--device cpu`` is passed).

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core import (task, io_task, trace, list_schedule,  # noqa: E402
                              simulate, ThreadedExecutor, execute_sequential,
                              theoretical_speedup)
from repro_torch.interop import resolve_device  # noqa: E402

# --- the paper's §2 example, verbatim shape; the device is a literal
# argument, so it adds no edge to the DAG -------------------------------


@io_task(cost=2.0)
def clean_files(device):
    print("  [io] clean_files")
    return torch.arange(64.0, device=device)    # "Summary"


@task(cost=5.0)
def complex_evaluation(x):
    return (x * x).sum()


@io_task(cost=2.0)
def semantic_analysis(device):
    print("  [io] semantic_analysis")
    return torch.tensor(42, device=device)


def _same(a, b) -> bool:
    return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the task values (default: the "
                         "CUDA card)")
    device = str(resolve_device(ap.parse_args(argv).device))

    def main_driver():
        x = clean_files(device)
        y = complex_evaluation(x)
        z = semantic_analysis(device)
        return y, z

    print("1) trace the driver -> dependency DAG (paper Fig. 1):")
    graph, outs = trace(main_driver)
    print("  ", graph.summary())
    for node in graph:
        deps = list(node.deps) + [f"RW:{t}" for t in node.token_deps]
        print(f"   {node.name}#{node.tid} kind={node.kind.value} deps={deps}")

    print("\n2) greedy ready-set schedule on 2 workers:")
    sched = list_schedule(graph, 2)
    for p in sorted(sched.placements.values(), key=lambda p: p.start):
        print(f"   w{p.worker}  t={p.start:4.1f}..{p.end:4.1f}  "
              f"{graph.nodes[p.tid].name}")
    print(f"   makespan {sched.makespan:.1f}s vs sequential "
          f"{graph.total_work():.1f}s "
          f"(bound {theoretical_speedup(graph, 2):.2f}x)")

    print("\n3) execute for real (4 threads, work stealing):")
    seq = execute_sequential(graph)
    par = ThreadedExecutor(4).run(graph)
    assert all(_same(seq[t], par[t]) for t in graph.outputs)
    print("   parallel == sequential, effects in program order  ✓")

    print("\n4) simulate the same DAG on a 512-worker cluster:")
    r = simulate(graph, 512)
    print(f"   makespan {r.makespan:.1f}s (span-bound — this tiny graph "
          f"has max_parallelism {graph.max_parallelism():.2f})")
    return {"graph": graph, "schedule": sched, "sequential": seq,
            "parallel": par, "simulated": r,
            "outputs": [seq[t] for t in graph.outputs], "device": device}


if __name__ == "__main__":
    main()

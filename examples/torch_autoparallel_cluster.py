"""The paper's full pipeline at cluster scale on the PyTorch port: trace →
schedule → work-stealing execution under failures/stragglers → SPMD mesh
lowering.

``examples/autoparallel_cluster.py`` on ``repro_torch``:
  inter-op (simulated): the matrix task DAG from the paper's §4 benchmark
            scheduled on a simulated 64-worker cluster, with a worker
            failure and lineage recovery mid-run;
  inter-op (REAL):      the same DAG executed by the multi-process
            ClusterExecutor — OS-process workers, driver-side object
            store — with one worker SIGKILLed mid-run and recovered via
            lineage + an elastic replacement join;
  intra-op: a matrix DAG lowered onto a device mesh by ``MeshExecutor``,
            the placement pass choosing every intermediate's layout, in a
            world started for it: 8 gloo ranks on a (4, 2) mesh with
            ``--device cpu``, one NCCL rank on a (1, 1) mesh on the card.

The task values are tensors on ``--device``: the CUDA card unless another
device is named (without a card it raises unless ``--device cpu`` is
passed).  Stage 5's collectives are counted by ``launch.costs.Counter``
(``MeshExecutor.cost_analysis``) where the reference counts the
partitioned HLO's.

Run: PYTHONPATH=src python examples/torch_autoparallel_cluster.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.cluster import ClusterExecutor  # noqa: E402
from repro_torch.config import ClusterConfig  # noqa: E402
from repro_torch.core import (task, trace, simulate, WorkerEvent,  # noqa: E402
                              execute_sequential, theoretical_speedup)
from repro_torch.interop import resolve_device  # noqa: E402

SPMD_TIMEOUT_S = 600.0

# the task bodies are module-level, their device a literal argument, so a
# graph pickles into spawned workers (the card's start method)


def _gen(seed, size, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((size, size), generator=g, device=device)


def _mul(a, b):
    from repro_torch.kernels import ops
    return ops.matmul(a, b)


def _red(*xs):
    return float(sum(float(x.sum()) for x in xs))


def _combine(*xs):
    return sum(xs)


def matrix_driver(n_tasks=32, size=64, device="cpu"):
    gen = task(_gen, cost=1.0, name="gen", out_bytes=size * size * 4)
    mul = task(_mul, cost=2.0, name="mul", out_bytes=size * size * 4)
    red = task(_red, cost=0.1, name="reduce")
    outs = []
    for i in range(n_tasks):
        outs.append(mul(gen(2 * i, size, device), gen(2 * i + 1, size,
                                                          device)))
    return red(*outs)


def spmd_rank(device: str) -> None:
    """Stage 5 on one rank of the world ``spawn_world`` started."""
    from repro_torch.core import MeshExecutor, ValueInfo, standard_rules
    from repro_torch.parallel.mesh import (destroy_world, init_world,
                                           make_mesh_for, world_size)
    torch.set_num_threads(1)
    init_world(device=device)
    try:
        gen = task(_gen, cost=1.0)
        mul = task(_mul, cost=2.0)
        combine = task(_combine, cost=0.1)

        def driver():
            return combine(*[mul(gen(2 * i, 256, device),
                                 gen(2 * i + 1, 256, device))
                             for i in range(4)])

        graph, _ = trace(driver)
        n = world_size()
        mesh = make_mesh_for(n, model_parallel=2 if n % 2 == 0 else 1)
        info = {t: ValueInfo((256, 256), 4, ("batch", "d_model"))
                for t in graph.nodes}
        ex = MeshExecutor(graph, mesh,
                          standard_rules("dp_tp", pod_axis=None),
                          value_info=info)
        out = ex({})[0]
        want = execute_sequential(graph)[graph.outputs[0]]
        # partitioned matmuls reduce in a different order than the
        # single-device oracle; tolerate reduction-reordering noise
        torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
        coll = ex.cost_analysis()["collectives"]
        if torch.distributed.get_rank() == 0:
            print(f"   SPMD lowering on {mesh.shape}: output matches "
                  f"sequential; {coll} collectives in the run "
                  f"(launch.costs.Counter)", flush=True)
    finally:
        destroy_world()


def main(argv=None):
    from repro_torch.parallel.mesh import spawn_world
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the task values (default: the "
                         "CUDA card)")
    ap.add_argument("--spmd-rank", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    if args.spmd_rank:
        return spmd_rank(device)

    graph, _ = trace(matrix_driver, device=device)
    print("1) traced matrix workload:", graph.summary())

    print("\n2) 64-worker cluster, fault-free:")
    base = simulate(graph, 64)
    print(f"   makespan {base.makespan:.2f}s  "
          f"(speedup {graph.total_work()/base.makespan:.1f}x, "
          f"bound {theoretical_speedup(graph, 64):.1f}x, "
          f"steals {base.n_steals})")

    print("\n3) same run, worker 0 dies + two stragglers appear:")
    events = [WorkerEvent(time=base.makespan * 0.4, kind="fail", worker=0),
              WorkerEvent(time=base.makespan * 0.3, kind="slow", worker=1,
                          factor=0.1),
              WorkerEvent(time=base.makespan * 0.3, kind="slow", worker=2,
                          factor=0.1)]
    r = simulate(graph, 64, events=events, speculate_after=1.5)
    print(f"   makespan {r.makespan:.2f}s "
          f"({r.makespan/base.makespan:.2f}x of fault-free) | "
          f"recomputed {r.n_recomputed} tasks (lineage) | "
          f"{r.n_speculative} speculative re-executions")

    print("\n4) REAL multi-process cluster: 4 OS-process workers, worker 0 "
          "SIGKILLed mid-run,\n   a replacement joins; lineage recovery + "
          "elastic replan keep the answer exact:")
    ex = ClusterExecutor(config=ClusterConfig(
        n_workers=4, fail_worker=(0, 4),
        join_after=(len(graph.nodes) // 2, 1)))
    res = ex.run(graph)
    want = execute_sequential(graph)
    assert all(torch.allclose(res[t], want[t])
               if isinstance(want[t], torch.Tensor) else res[t] == want[t]
               for t in graph.nodes)
    plan_sizes = [len(e["plan"]) for e in ex.recovery_events]
    print(f"   {len(graph.nodes)} tasks in {ex.wall_time:.2f}s | "
          f"failures {ex.stats['failures']} (recomputed "
          f"{ex.stats['recomputed']} = lineage plan {plan_sizes}) | "
          f"joins {ex.stats['joins']} | transfers {ex.stats['transfers']} "
          f"| matches sequential oracle ✓")

    ranks = 8 if device == "cpu" else 1
    print(f"\n5) lower the DAG onto {'an' if ranks == 8 else 'a'} "
          f"{ranks}-device SPMD mesh (subprocess):")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    outs = spawn_world([os.path.abspath(__file__), "--spmd-rank",
                        "--device", device], ranks,
                       timeout_s=SPMD_TIMEOUT_S, env=env)
    print(outs[0].rstrip())
    print("\nall stages OK  ✓")
    return {"graph": graph, "simulated": base, "faulty": r,
            "cluster_stats": dict(ex.stats), "spmd": outs[0],
            "device": device}


if __name__ == "__main__":
    main()

"""repro_torch.core — the paper's auto-parallelizer, on PyTorch.

Port of ``repro/core/__init__.py``, exporting what is ported so far:
  task, io_task, trace, placeholder, checkpoint_barrier   (build a DAG)
  broadcast, scatter, gather, all_reduce                  (collective nodes
      and their lowering to staged trees — core/collectives.py)
  TaskGraph                                               (the IR)
  fuse, FusedPlan, parse_fuse_spec                        (graph compilation:
      cluster the DAG into super-tasks before dispatch — core/fusion.py)
  infer_purity, declare, declared_purity                  (purity)
  EffectToken, initial_token                              (RealWorld tokens)
  list_schedule, replan                                   (static scheduling)
  ClusterSim, simulate, WorkerEvent                       (cluster simulator)
  Executor, execute_sequential, ThreadedExecutor,
  run_graph, make_executor                                (real execution;
      backend="thread" stays in-process, backend="process" selects the
      multi-process repro_torch.cluster.ClusterExecutor runtime)
  MeshExecutor                                            (SPMD: the graph
      on every rank of a device mesh, over DTensors; imported on first
      use, so a process that runs no mesh loads no DTensor machinery)
  recovery_plan, recover                                  (lineage FT)
  standard_rules, logical_to_spec, tree_shardings,
  ValueInfo, refine_placements, resharding_bytes          (auto-sharding:
      rule tables and the greedy placement refinement)

The rule tables also lay out the launchers' models under ``--tp``
(``parallel.sharding``): DTensor parameters, the flash and scan kernels on
each rank's local shard, ``shard_grads``.
"""
from .graph import TaskGraph, TaskNode, TaskKind, GraphError
from .tracing import (task, io_task, trace, placeholder, checkpoint_barrier,
                      broadcast, scatter, gather, all_reduce,
                      Trace, TaskRef, fuse_cheap_chains, substitute_refs)
from .collectives import (lower_collectives, parse_collectives_spec,
                          tree_fold, collective_stages,
                          add_all_reduce, add_gather, add_broadcast,
                          add_scatter)
from .purity import infer_purity, declare, declared_purity
from .effects import EffectToken, initial_token
from .fusion import (FusedPlan, WorkerFusionView, fuse, identity_plan,
                     parse_fuse_spec)
from .scheduler import (Schedule, Placement, list_schedule, replan,
                        theoretical_speedup, collective_comm_cost)
from .simulator import ClusterSim, SimResult, WorkerEvent, simulate
from .executor import (execute_sequential, ThreadedExecutor, run_graph,
                       make_executor, output_values, Executor, TaskFailed)
from .lineage import recovery_plan, recover, replay, lineage_depth, NonIdempotentReplay
from .placement import (standard_rules, sequence_parallel_rules,
                        logical_to_spec, sharding_for, tree_specs,
                        tree_shardings, ValueInfo, refine_placements,
                        resharding_bytes, total_resharding_bytes, spec_shards)

__all__ = [k for k in dir() if not k.startswith("_")] + ["MeshExecutor"]


def __getattr__(name):
    if name == "MeshExecutor":
        from .mesh_executor import MeshExecutor
        globals()["MeshExecutor"] = MeshExecutor
        return MeshExecutor
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

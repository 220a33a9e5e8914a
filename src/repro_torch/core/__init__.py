"""repro_torch.core — the paper's auto-parallelizer, on PyTorch.

Port of ``repro/core/__init__.py``, exporting what is ported so far:
  task, io_task, trace, placeholder, checkpoint_barrier   (build a DAG)
  broadcast, scatter, gather, all_reduce                  (collective nodes
      and their lowering to staged trees — core/collectives.py)
  TaskGraph                                               (the IR)
  infer_purity, declare, declared_purity                  (purity)
  EffectToken, initial_token                              (RealWorld tokens)
  list_schedule, replan                                   (static scheduling)
  Executor, execute_sequential, ThreadedExecutor,
  run_graph, make_executor                                (real execution,
      backend="thread")
  recovery_plan, recover                                  (lineage FT)

The simulator, fusion, adaptive replanning, placement and the mesh executor
come with later slices (ROADMAP §1).
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
from .scheduler import (Schedule, Placement, list_schedule, replan,
                        theoretical_speedup, collective_comm_cost)
from .executor import (execute_sequential, ThreadedExecutor, run_graph,
                       make_executor, output_values, Executor, TaskFailed)
from .lineage import recovery_plan, recover, replay, lineage_depth, NonIdempotentReplay

__all__ = [k for k in dir() if not k.startswith("_")]

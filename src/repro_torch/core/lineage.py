"""Lineage-based fault tolerance (the Spark/RDD idea the paper points at).

Port of ``repro/core/lineage.py``, unchanged: lineage is plain Python.
The cluster-granularity helpers take a fused plan, which arrives with the
fusion pass in a later slice of the port.

Because every non-``IO`` task is pure, a lost result can always be
reconstructed by re-running its lineage — the minimal set of ancestor tasks
whose results are also unavailable.  Checkpoint BARRIER nodes cut lineage:
anything materialized at a barrier is durable, so recovery never recomputes
past one.

Effectful tasks are NOT replayed blindly (re-running ``IO`` may duplicate a
side effect); :func:`recovery_plan` flags them so callers can substitute a
checkpointed value or re-run only idempotent ones (``meta={'idempotent': True}``).
"""
from __future__ import annotations

from typing import Dict, Iterable, Set, Tuple

from .graph import TaskGraph, TaskKind


class NonIdempotentReplay(RuntimeError):
    pass


def recovery_plan(
    graph: TaskGraph,
    lost: Iterable[int],
    available: Set[int],
    *,
    allow_effect_replay: bool = True,
) -> Set[int]:
    """Minimal recompute set to rebuild ``lost`` given ``available`` results.

    Walks lineage upward from each lost task, stopping at results that are
    still available (or durable barriers).  Raises
    :class:`NonIdempotentReplay` if an effectful, non-idempotent task would
    have to be replayed and ``allow_effect_replay`` is False.
    """
    plan: Set[int] = set()
    stack = [t for t in lost if t not in available]
    while stack:
        tid = stack.pop()
        if tid in plan:
            continue
        node = graph.nodes[tid]
        if node.kind is TaskKind.EFFECTFUL and not allow_effect_replay:
            if not node.meta.get("idempotent", False):
                raise NonIdempotentReplay(
                    f"recovery would replay non-idempotent IO task "
                    f"{node.name}#{tid}; checkpoint its output instead")
        plan.add(tid)
        for d in node.all_deps:
            if d not in available and d not in plan:
                stack.append(d)
    return plan


def recovery_plan_clusters(
    fused_plan,
    needed: Iterable[int],
    available: Set[int],
) -> Set[int]:
    """Super-task-granularity recovery: the minimal set of *clusters* to
    re-run so every ``needed`` member value (and every external input a
    re-run cluster will read) exists again.

    ``fused_plan`` is a :class:`repro.core.fusion.FusedPlan`;
    ``needed``/``available`` are member-value tids, exactly as in
    :func:`recovery_plan`.  Walks the cluster DAG through each re-run
    cluster's **external** inputs — intra-cluster values are rebuilt by
    the cluster's own execution and never enter the walk.  For the
    identity plan this degenerates to :func:`recovery_plan` (one cluster
    per task, external inputs == ``all_deps``), which is what keeps
    ``--fuse off`` recovery bit-compatible.

    Collective trees get subtree-bounded recovery for free: a lowered
    stage node (:func:`repro_torch.core.collectives.lower_collectives`) is
    always its own singleton cluster, so losing a mid-tree aggregator
    replays that stage plus whichever of its inputs also died — never
    the sibling subtrees, whose partials are alive on other workers
    (``repro_torch.core.collectives.collective_stages`` enumerates a root's
    stage set; tests assert the plan stays inside it).
    """
    plan: Set[int] = set()
    stack = [fused_plan.cluster_of[v] for v in needed if v not in available]
    while stack:
        cid = stack.pop()
        if cid in plan:
            continue
        plan.add(cid)
        for v in fused_plan.ext_deps[cid]:
            pc = fused_plan.cluster_of[v]
            if v not in available and pc not in plan:
                stack.append(pc)
    return plan


def phantom_recovery_cost(
    fused_plan,
    suspect_values: Iterable[int],
    available: Set[int],
) -> Set[int]:
    """Clusters a *premature* death verdict would needlessly re-run.

    A partitioned-but-alive worker's values are all still there — just
    unreachable until the partition heals.  Declaring it dead anyway
    treats ``suspect_values`` (everything whose only copy it holds) as
    lost and replays their lineage.  This is the waste term the
    executor's ``suspect_grace`` window exists to avoid, and the cost a
    grace policy search (:func:`repro.core.simulator.search_suspect_grace`)
    weighs against the idle time of waiting out a worker that really is
    dead."""
    suspect = set(suspect_values)
    return recovery_plan_clusters(fused_plan, suspect,
                                  set(available) - suspect)


def outage_recovery(
    fused_plan,
    graph: TaskGraph,
    claimed_done: Set[int],
    available: Set[int],
    outputs_only: bool = False,
) -> Tuple[Set[int], Set[int], Set[int]]:
    """Recovery after a *driver* outage: reconcile checkpoint claims
    against surviving inventory.

    ``claimed_done`` is the set of clusters the run log says completed;
    ``available`` is every member value actually reachable right now
    (rejoined workers' inventories + reattached durable handles +
    checkpoint-spilled values).  Claims are monotone-but-stale — a value
    may have been produced, consumed, GC'd, and its producer legitimately
    never needs to re-run; or it may have died with a worker during the
    outage and must be replayed.

    Returns ``(lost, needed, plan)``: the claimed values that are gone,
    the subset a resumed run still has to rebuild (all of them in
    full-results mode; in ``outputs_only`` mode only graph outputs and
    values with unconsumed downstream clusters), and the cluster replay
    plan from :func:`recovery_plan_clusters` — exactly one plan per
    outage, however many workers died with it.
    """
    lost: Set[int] = set()
    for cid in claimed_done:
        for v in fused_plan.members[cid]:
            if v not in available:
                lost.add(v)
    if not outputs_only:
        needed = set(lost)
    else:
        needed = set()
        for v in lost:
            if v in graph.outputs:
                needed.add(v)
                continue
            for consumer in fused_plan.consumers.get(v, ()):
                if consumer not in claimed_done:
                    needed.add(v)
                    break
    plan = recovery_plan_clusters(fused_plan, needed, available)
    return lost, needed, plan


def replay(graph: TaskGraph, plan: Set[int], results: Dict[int, object]) -> None:
    """Execute ``plan`` in topo order, writing into ``results`` in place."""
    from .executor import _run_node   # local import to avoid a cycle
    order = [t for t in graph.topo_order() if t in plan]
    for tid in order:
        results[tid] = _run_node(graph, tid, results)


def recover(graph: TaskGraph, lost: Iterable[int],
            results: Dict[int, object], **kw) -> Set[int]:
    """Convenience: plan + replay. Returns the set of recomputed tasks."""
    lost = set(lost)
    for t in lost:
        results.pop(t, None)
    plan = recovery_plan(graph, lost, set(results), **kw)
    replay(graph, plan, results)
    return plan


def lineage_depth(graph: TaskGraph, tid: int, available: Set[int]) -> int:
    """How many tasks a single loss would force us to recompute — the metric
    that motivates checkpoint-barrier placement."""
    return len(recovery_plan(graph, {tid}, available - {tid}))

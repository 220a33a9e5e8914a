"""Greedy ready-set scheduling — the paper's scheduler, made concrete.

Port of ``repro/core/scheduler.py``, unchanged: the scheduler is plain
Python.  The modules named below (simulator, fusion, mesh executor) are
those of the reference package; their ports come in later slices.

The paper: "a scheduler ... greedily schedules tasks to worker nodes as their
inputs are ready".  We implement that greedy rule and extend it with the two
standard refinements a production system needs:

* **priority** within the ready set — critical-path (HEFT ``rank_u``) first,
  FIFO and random as ablation baselines;
* **worker choice** — earliest-finish-time over heterogeneous-speed workers,
  with an optional per-edge communication delay (locality-aware).

The static schedule produced here is used (a) directly by the mesh executor
to order SPMD task launches, (b) as the baseline the work-stealing runtime
(:mod:`repro.core.simulator`, :mod:`repro_torch.core.executor`) is compared
against, and (c) for elastic re-planning when the worker set changes.

Since the fusion pass (:mod:`repro.core.fusion`) the cluster runtime plans
over the *fused* cluster-level graph, not the raw task graph: node ids are
super-task ids, ``cost``/``out_bytes`` are aggregates, and the
``data_sizes`` comm-cost term therefore prices only **cross-cluster**
edges — intra-cluster values never move, so they never enter the plan.
Nothing here special-cases that: a ``FusedPlan.cgraph`` is an ordinary
:class:`TaskGraph`, which is the point.

Collectives get the same treatment, one pass earlier: a traced
``all_reduce``/``gather``/``broadcast`` node would price as N×M
point-to-point edges here, but
:func:`repro_torch.core.collectives.lower_collectives` rewrites it into an
arity-bounded stage tree *before* planning, so the graph this module
sees already has log-depth structure — every node's fan-in is at most
the tree arity, the comm term prices one hop per value per level, and
EFT spreads sibling stages across workers for free.
:func:`collective_comm_cost` is the closed-form of that price, used by
the offline arity search (``simulator.search_collective_arity``) and
``docs/collectives.md``'s costing model.
"""
from __future__ import annotations

import dataclasses
import heapq
import random as _random
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .graph import TaskGraph


@dataclasses.dataclass(frozen=True)
class Placement:
    tid: int
    worker: int
    start: float
    end: float


@dataclasses.dataclass
class Schedule:
    placements: Dict[int, Placement]
    n_workers: int

    @property
    def makespan(self) -> float:
        return max((p.end for p in self.placements.values()), default=0.0)

    def order_for_worker(self, worker: int) -> List[int]:
        ps = [p for p in self.placements.values() if p.worker == worker]
        return [p.tid for p in sorted(ps, key=lambda p: p.start)]

    def utilization(self) -> float:
        busy = sum(p.end - p.start for p in self.placements.values())
        total = self.makespan * self.n_workers
        return busy / total if total > 0 else 1.0

    def expected_durations(self) -> Dict[int, float]:
        """Static cost-model hint: the planned execution time of each task
        (``end - start`` of its placement, i.e. ``cost / worker_speed`` —
        queue/transfer waits are not included).  The cluster runtime's
        speculation policy calibrates these cost-unit durations into
        seconds with a runtime EWMA to decide when a running task is
        overdue (see ``docs/speculation.md``)."""
        return {tid: p.end - p.start for tid, p in self.placements.items()}

    def validate_against(self, graph: TaskGraph) -> None:
        """Every dep finishes before its consumer starts; no worker overlap."""
        for node in graph.nodes.values():
            p = self.placements[node.tid]
            for d in node.all_deps:
                if self.placements[d].end > p.start + 1e-9:
                    raise AssertionError(
                        f"task {node.tid} starts before dep {d} ends")
        by_worker: Dict[int, List[Placement]] = {}
        for p in self.placements.values():
            by_worker.setdefault(p.worker, []).append(p)
        for ps in by_worker.values():
            ps.sort(key=lambda p: p.start)
            for a, b in zip(ps, ps[1:]):
                if a.end > b.start + 1e-9:
                    raise AssertionError("overlapping tasks on one worker")


def list_schedule(
    graph: TaskGraph,
    n_workers: int,
    *,
    policy: str = "critical_path",       # | "fifo" | "random"
    worker_speed: Optional[Sequence[float]] = None,
    comm_cost: Optional[Callable[[int, int], float]] = None,
    seed: int = 0,
    start_time: float = 0.0,
    done: Optional[Dict[int, float]] = None,
    data_sizes: Optional[Dict[int, int]] = None,
    bandwidth: float = float(256 << 20),
    placed: Optional[Dict[int, int]] = None,
    worker_host: Optional[Sequence[Any]] = None,
    near_factor: float = 0.25,
    cost_scale: float = 1.0,
) -> Schedule:
    """Greedy list scheduling.

    ``cost_scale`` converts abstract ``node.cost`` units into the seconds
    the comm-cost terms are priced in (``size / bandwidth``).  The
    default ``1.0`` keeps the historical convention that one cost unit is
    one second; the adaptive runtime passes its measured
    ``CostModel.unit_s`` (seconds per unit) so compute and transfer
    finally land on one axis and the EFT trade-off between "run near the
    data" and "run on the free worker" uses real magnitudes.  Placements
    and :meth:`Schedule.expected_durations` come back in the scaled
    (seconds) axis.

    ``done`` maps already-completed task ids to their completion times —
    used for elastic re-planning mid-flight (those tasks are not rescheduled
    but their finish times gate successors).

    Transfer-cost-aware placement: ``data_sizes`` (task id -> payload
    bytes, as recorded by the cluster runtime at completion) synthesizes a
    per-edge ``comm_cost`` of ``size / bandwidth`` when none is given, and
    ``placed`` (task id -> worker index for already-completed tasks) makes
    that cost apply to edges out of *completed* work too — so a mid-run
    replan keeps consumers next to the worker already holding their input
    bytes instead of treating finished values as free everywhere.

    ``worker_host`` (one machine id per worker index) adds per-host
    locality grouping to the synthesized cost: an edge between two workers
    on the same host moves over shared memory / a unix socket and costs
    ``near_factor`` of the cross-host (TCP) price, so the plan prefers
    keeping a value's consumers on the machine that holds it while still
    treating two same-host workers as distinct.  It scales only the
    synthesized ``data_sizes`` cost; an explicit ``comm_cost`` callable is
    used verbatim.
    """
    if n_workers <= 0:
        raise ValueError("need at least one worker")
    speeds = list(worker_speed) if worker_speed else [1.0] * n_workers
    if len(speeds) != n_workers:
        raise ValueError("worker_speed length mismatch")
    hosts = list(worker_host) if worker_host is not None else None
    if hosts is not None and len(hosts) != n_workers:
        raise ValueError("worker_host length mismatch")
    done = dict(done or {})
    placed = dict(placed or {})
    edge_cost: Optional[Callable[[int, int, int, int], float]] = None
    if comm_cost is not None:
        cc = comm_cost
        edge_cost = lambda d, t, pw, w: cc(d, t)            # noqa: E731
    elif data_sizes:
        sizes = data_sizes

        def edge_cost(d: int, t: int, pw: int, w: int) -> float:
            c = sizes.get(d, 0) / bandwidth
            if hosts is not None and hosts[pw] == hosts[w]:
                c *= near_factor            # same-host move: shm-near
            return c
    rng = _random.Random(seed)

    rank = graph.critical_path_rank()
    if policy == "critical_path":
        prio = lambda tid: (-rank[tid], tid)
    elif policy == "fifo":
        prio = lambda tid: (tid,)
    elif policy == "random":
        jitter = {tid: rng.random() for tid in graph.nodes}
        prio = lambda tid: (jitter[tid], tid)
    else:
        raise ValueError(f"unknown policy {policy!r}")

    indeg = graph.in_degree()
    succ = graph.successors()
    finish: Dict[int, float] = dict(done)
    for tid in done:
        for s in succ.get(tid, []):
            indeg[s] -= 1
    ready: List[Tuple] = []
    for tid, d in indeg.items():
        if tid in done:
            continue
        if d == 0:
            heapq.heappush(ready, (*prio(tid), tid))

    worker_free = [start_time] * n_workers
    placements: Dict[int, Placement] = {}

    while ready:
        entry = heapq.heappop(ready)
        tid = entry[-1]
        node = graph.nodes[tid]
        deps_done = max((finish[d] for d in node.all_deps), default=start_time)
        # earliest-finish-time worker choice
        best = None
        for w in range(n_workers):
            est = max(worker_free[w], deps_done)
            if edge_cost is not None:
                for d in node.deps:
                    if d in placements:
                        pw = placements[d].worker
                    else:           # completed task: known owner, else local
                        pw = placed.get(d, w)
                    if pw != w:
                        est = max(est, finish[d] + edge_cost(d, tid, pw, w))
            dur = node.cost * cost_scale / speeds[w]
            eft = est + dur
            if best is None or eft < best[0]:
                best = (eft, est, w)
        eft, est, w = best  # type: ignore[misc]
        placements[tid] = Placement(tid, w, est, eft)
        worker_free[w] = eft
        finish[tid] = eft
        for s in succ[tid]:
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(ready, (*prio(s), s))

    if len(placements) + len(done) != len(graph.nodes):
        raise AssertionError("scheduler did not place every task")
    return Schedule(placements, n_workers)


def replan(
    graph: TaskGraph,
    completed: Dict[int, float],
    n_workers: int,
    now: float,
    **kw,
) -> Schedule:
    """Elastic re-plan: schedule only the not-yet-completed tasks on the new
    worker set (workers may have joined or left)."""
    return list_schedule(graph, n_workers, done=completed, start_time=now, **kw)


def fair_interleave(
    items: Sequence[Any],
    tenant_of: Callable[[Any], Any],
    key: Callable[[Any], Any],
    weights: Optional[Dict[Any, float]] = None,
) -> List[Any]:
    """Weighted round-robin interleave of a ready set across tenants.

    The resident (multi-tenant) executor dispatches from one union ready
    set; a plain global priority sort would let a tenant with a wide,
    high-rank graph starve everyone else's short interactive jobs.  This
    deterministically reorders ``items`` so each scheduling pass offers
    every tenant a slot before any tenant gets a second one (``weights``
    scale slots-per-round; fractional weights accumulate as deficits, so
    a weight of 0.5 yields a slot every other round).

    Within a tenant, ``key`` orders its own items (the executor passes its
    usual critical-path priority), so fairness is *between* tenants only —
    each tenant's work still runs in rank order.  Pure and deterministic:
    equal inputs give equal output, keeping replays and differential tests
    stable.
    """
    groups: Dict[Any, List[Any]] = {}
    for it in items:
        groups.setdefault(tenant_of(it), []).append(it)
    for g in groups.values():
        g.sort(key=key)
    tenants = sorted(groups, key=repr)
    idx = {t: 0 for t in tenants}
    credit = {t: 0.0 for t in tenants}
    out: List[Any] = []
    while len(out) < len(items):
        progressed = False
        for t in tenants:
            w = float((weights or {}).get(t, 1.0))
            credit[t] += max(0.0, w)
            g = groups[t]
            while credit[t] >= 1.0 and idx[t] < len(g):
                credit[t] -= 1.0
                out.append(g[idx[t]])
                idx[t] += 1
                progressed = True
        if not progressed:
            # only zero-weight (or credit-starved) tenants left: drain them
            # round-robin so every ready item is still eventually offered
            for t in tenants:
                if idx[t] < len(groups[t]):
                    out.append(groups[t][idx[t]])
                    idx[t] += 1
    return out


def theoretical_speedup(graph: TaskGraph, n_workers: int) -> float:
    """Brent's bound: T_p >= max(T_1 / p, T_inf); speedup <= T_1 / that."""
    t1 = graph.total_work()
    tinf = graph.critical_path_length()
    tp = max(t1 / n_workers, tinf)
    return t1 / tp if tp > 0 else 1.0


def collective_comm_cost(n: int, consumers: int, value_bytes: int,
                         bandwidth: float, *, arity: int = 4,
                         n_hosts: int = 1,
                         cross_host_penalty: float = 2.0) -> float:
    """Closed-form structured-shape price of a lowered reduction/gather
    feeding ``consumers`` readers — the model behind the collective
    lowering's win over N×M point-to-point edges.

    Point-to-point moves ``n × consumers`` values; the tree moves one
    value per input up a ``ceil(log_arity n)``-depth combine tree (at
    most ``n - 1`` hop transfers in total, levels overlapping across
    workers) and one result per consumer down — ``~(n + consumers)``
    transfers instead of ``n × consumers``.  With ``n_hosts > 1`` each
    host's members reduce locally first (intra-host hops on the shm
    fast path) and exactly one partial per host crosses the boundary —
    priced at ``cross_host_penalty``×, mirroring
    ``ClusterExecutor.move_cost`` doubling cross-host bytes.  Compare
    against ``n * consumers * value_bytes / bandwidth`` to decide when
    point-to-point still wins (tiny n, or one consumer —
    docs/collectives.md)."""
    if bandwidth <= 0:
        return 0.0
    per_value = value_bytes / bandwidth
    arity = max(2, arity)
    up_hops = max(0, n - 1)             # combine-tree edges, all levels
    if n_hosts > 1:
        intra = max(0, n - n_hosts)     # local partial reductions
        cross = n_hosts - 1             # one partial per host crosses
        up = intra * per_value + cross * per_value * cross_host_penalty
    else:
        up = up_hops * per_value
    down = consumers * per_value        # result fan-out (broadcast tree)
    return up + down

"""Deterministic discrete-event cluster simulator.

Port of ``repro/core/simulator.py``, unchanged: the simulator is plain Python.

The paper evaluates its greedy/work-stealing scheduler on Cloud Haskell
workers.  This container has one CPU, so — exactly like the paper "simulated"
workers with Cloud Haskell processes on one box — we simulate a cluster with
a discrete-event model: heterogeneous worker speeds, work-stealing deques,
steal latency, worker failures (→ lineage recovery), stragglers
(→ speculative re-execution), elastic joins, and **fused execution**
(``fuse=`` runs the sim over the same super-task graph the real driver
dispatches, with ``dispatch_overhead`` charging the per-dispatch
control-plane cost fusion amortizes away).

Everything is deterministic given the seed, which makes the scheduler's
behaviour property-testable (see ``tests/test_scheduler.py``).
"""
from __future__ import annotations

import dataclasses
import heapq
import random as _random
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from .adaptive import (CostModel, RefuseGovernor, RunTrace, fn_key,
                       refusion_due)
from .collectives import (CollectivesSpec, lower_collectives,
                          parse_collectives_spec)
from .fusion import FusedPlan, FuseSpec, fuse as fuse_graph
from .graph import TaskGraph, TaskKind

DURABLE = -1   # pseudo-worker id: result survives any failure (checkpointed)


def pick_speculation(running: Dict[int, Tuple[float, float]],
                     speculate_after: float) -> Optional[int]:
    """The speculation policy, shared by this simulator and the real
    :class:`repro_torch.cluster.ClusterExecutor` so the two provably agree on
    *which* task a free worker duplicates (see
    ``tests/test_speculation.py``).

    ``running`` maps a singly-in-flight task id to ``(elapsed, expected)``
    durations — elapsed wall time so far vs the expected duration from the
    cost model (sim: nominal ``node.cost``; runtime: the static
    ``list_schedule`` duration calibrated by a runtime EWMA).  Returns the
    most-overdue task whose ``elapsed > speculate_after × expected`` (ties
    to the lower tid), or ``None`` when nothing is overdue enough.
    """
    best: Optional[Tuple[float, int]] = None
    for tid, (elapsed, expected) in running.items():
        overdue = elapsed / max(expected, 1e-12)
        if overdue <= speculate_after:
            continue
        if best is None or (overdue, -tid) > (best[0], -best[1]):
            best = (overdue, tid)
    return None if best is None else best[1]


@dataclasses.dataclass
class WorkerEvent:
    """Cluster dynamics injected into a run."""
    time: float
    kind: str           # "fail" | "join" | "slow" | "partition"
    worker: int
    factor: float = 1.0  # "slow": multiply speed by this;
    #                      "partition": seconds the worker is unreachable


@dataclasses.dataclass
class SimResult:
    makespan: float
    n_steals: int = 0
    n_recomputed: int = 0
    n_speculative: int = 0
    n_failures: int = 0
    # partition / suspect-grace accounting ("partition" events):
    n_suspected: int = 0     # partitions that opened on a live worker
    n_healed: int = 0        # partitions outwaited inside suspect_grace
    n_false_deaths: int = 0  # live workers declared dead by an expired grace
    speculated: Set[int] = dataclasses.field(default_factory=set)
    busy_time: Dict[int, float] = dataclasses.field(default_factory=dict)
    task_worker: Dict[int, int] = dataclasses.field(default_factory=dict)
    timeline: List[Tuple[float, str]] = dataclasses.field(default_factory=list)
    # adaptive trigger model (``adaptive="auto"``): how many times, and
    # when, the re-fusion governor would have fired on this run
    refusions: int = 0
    refusion_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def utilization(self) -> float:
        if not self.busy_time or self.makespan <= 0:
            return 1.0
        return sum(self.busy_time.values()) / (self.makespan * len(self.busy_time))


class ClusterSim:
    def __init__(
        self,
        graph: TaskGraph,
        n_workers: int,
        *,
        worker_speed: Optional[List[float]] = None,
        steal_latency: float = 0.0,
        allow_steal: bool = True,
        comm_per_byte: float = 0.0,
        events: Optional[List[WorkerEvent]] = None,
        speculate_after: Optional[float] = None,  # ×expected-duration threshold
        policy: str = "critical_path",
        seed: int = 0,
        fuse: FuseSpec = "off",
        collectives: CollectivesSpec = "auto",
        dispatch_overhead: float = 0.0,
        driver_kill: Optional[float] = None,
        driver_dead_workers: Optional[List[int]] = None,
        driver_resume_latency: float = 1.0,
        suspect_grace: float = 5.0,
        adaptive: str = "off",
        refuse_skew: float = 4.0,
        trace: Optional[RunTrace] = None,
        fuse_kw: Optional[Dict[str, float]] = None,
    ) -> None:
        graph.validate()
        # collective lowering first, exactly as ClusterExecutor does: the
        # sim prices the SAME staged tree hops the real driver dispatches,
        # which is what makes the offline arity search
        # (search_collective_arity) transfer to the runtime.  Unlike the
        # executor, the sim reshapes reduce trees under an integer spec —
        # it prices shapes and never touches values, so candidate arities
        # can be modeled without the bit-equality constraint
        graph, _ = lower_collectives(graph, parse_collectives_spec(
            collectives), reshape_reductions=True)
        # fused execution model: the sim runs over the SAME cluster-level
        # graph the real driver dispatches (repro_torch.core.fusion), and
        # ``dispatch_overhead`` charges the per-dispatch control-plane
        # round-trip (BENCH_multihost: ~0.78 ms/task on TCP) each task
        # start pays — so policy studies of fusion granularity transfer:
        # fewer clusters ⇒ fewer overheads, identical total work.
        # ``fuse_kw`` forwards fusion knobs (keep_parallelism, fanin_cost,
        # group_cost) so the offline policy search can price candidate
        # REGROUPINGS of the same graph — the simulator half of the
        # adaptive re-fusion loop (docs/adaptive.md)
        self.plan: FusedPlan = fuse_graph(graph, fuse, **(fuse_kw or {}))
        # member-level graph, kept around so a recorded RunTrace (keyed by
        # member tid) can price any candidate clustering of the same tasks
        self.member_graph = graph
        graph = self.plan.cgraph
        self.dispatch_overhead = dispatch_overhead
        self.graph = graph
        self.trace = trace
        # adaptive="auto" models the RE-FUSION TRIGGER: the sim feeds the
        # same CostModel/RefuseGovernor the live driver uses and counts
        # where the governor fires (SimResult.refusions /
        # .refusion_times).  It does not re-splice the plan mid-sim —
        # candidate regroupings are priced by re-running with ``fuse_kw``
        # / ``trace``, which is exactly what search_policy does.
        if adaptive not in ("off", "auto"):
            raise ValueError(f"adaptive must be 'off' or 'auto': {adaptive}")
        self.adaptive = adaptive
        self._model: Optional[CostModel] = None
        self._governor: Optional[RefuseGovernor] = None
        if adaptive == "auto":
            self._model = CostModel(dispatch_s=dispatch_overhead)
            self._governor = RefuseGovernor(skew_threshold=refuse_skew)
        self.n_workers = n_workers
        self.speed = {w: (worker_speed[w] if worker_speed else 1.0)
                      for w in range(n_workers)}
        self.steal_latency = steal_latency
        self.allow_steal = allow_steal
        self.comm_per_byte = comm_per_byte
        self.events = sorted(events or [], key=lambda e: e.time)
        self.speculate_after = speculate_after
        self.rng = _random.Random(seed)
        self.rank = graph.critical_path_rank()
        if policy not in ("critical_path", "fifo", "random"):
            raise ValueError(policy)
        self.policy = policy
        self._jitter = {tid: self.rng.random() for tid in graph.nodes}
        # driver-outage model (mirrors ClusterExecutor checkpoint/resume):
        # at ``driver_kill`` the driver stops dispatching; workers in
        # ``driver_dead_workers`` die with it; everyone else keeps running
        # what they hold and buffers completions.  ``driver_resume_latency``
        # later the restarted driver re-adopts survivors, reconciles the
        # buffered work, and recovers every confirmed loss in ONE pass.
        self.driver_kill = driver_kill
        self.driver_dead_workers = list(driver_dead_workers or [])
        self.driver_resume_latency = driver_resume_latency
        # partition model (mirrors the executor's suspect-vs-dead policy,
        # docs/faults.md): a "partition" event makes a worker unreachable
        # for ``factor`` seconds — no new dispatches, its completions
        # buffer until the heal.  A partition longer than ``suspect_grace``
        # is indistinguishable from death at the driver, so the worker is
        # declared dead at grace expiry (its sole-copy values replay via
        # lineage — the *phantom* recovery cost) and rejoins empty at heal
        # time.  Sweeping this knob offline is the grace policy search.
        self.suspect_grace = max(0.0, suspect_grace)

    # priority of a ready task (lower = sooner)
    def _prio(self, tid: int) -> Tuple:
        if self.policy == "critical_path":
            return (-self.rank[tid], tid)
        if self.policy == "fifo":
            return (tid,)
        return (self._jitter[tid], tid)

    # ---------------------------------------------------------------- run
    def run(self) -> SimResult:
        g = self.graph
        succ = g.successors()
        res = SimResult(makespan=0.0)

        alive: Set[int] = set(range(self.n_workers))
        deques: Dict[int, deque] = {w: deque() for w in alive}
        # results_at[tid] = set of workers holding the value (or DURABLE)
        results_at: Dict[int, Set[int]] = {}
        done: Set[int] = set()
        # running[w] = (tid, start, end, epoch); epoch invalidates stale events
        running: Dict[int, Tuple[int, float, float, int]] = {}
        partitioned: Dict[int, float] = {}   # w -> heal time (unreachable)
        busy: Dict[int, float] = {w: 0.0 for w in alive}
        inflight: Dict[int, Set[int]] = {}   # tid -> workers currently running it
        epoch = 0

        evq: List[Tuple[float, int, str, tuple]] = []
        seq = 0

        def push(t: float, kind: str, data: tuple) -> None:
            nonlocal seq
            heapq.heappush(evq, (t, seq, kind, data))
            seq += 1

        for e in self.events:
            push(e.time, e.kind, (e.worker, e.factor))
        driver_down = False
        if self.driver_kill is not None:
            push(self.driver_kill, "driver_kill", ())
            push(self.driver_kill + self.driver_resume_latency,
                 "driver_resume", ())

        def ready_p(tid: int) -> bool:
            # NB: inflight values are sets that may be empty after a
            # discard — membership must be by truthiness, not key presence,
            # or recomputed tasks are blocked forever.
            return (tid not in done and not inflight.get(tid)
                    and all(d in done for d in g.nodes[tid].all_deps))

        pending: Set[int] = set(g.nodes)
        central: List[Tuple] = []   # overflow queue for tasks with no owner

        def enqueue_ready_from(tid_done: int, worker: int) -> None:
            """Paper's greedy rule: schedule successors the moment their
            inputs are ready; locality: place on the finishing worker's deque."""
            for s in succ[tid_done]:
                if s in pending and ready_p(s):
                    deques[worker].appendleft(s) if worker in deques else \
                        heapq.heappush(central, (*self._prio(s), s))

        def start_task(w: int, tid: int, now: float, speculative: bool = False):
            nonlocal epoch
            node = g.nodes[tid]
            if self.trace is not None:
                # trace replay: recorded per-member seconds (declared cost
                # × recorded unit rate for never-observed members), so the
                # same trace prices ANY candidate clustering of the tasks
                work = self.trace.cluster_seconds(
                    self.plan.members.get(tid, (tid,)),
                    self.member_graph.nodes)
            else:
                work = node.cost
            dur = work / self.speed[w] + self.dispatch_overhead
            # input fetch cost: bytes from deps whose results live elsewhere
            if self.comm_per_byte > 0.0:
                for d in node.deps:
                    holders = results_at.get(d, set())
                    if w not in holders and DURABLE not in holders:
                        dur += g.nodes[d].out_bytes * self.comm_per_byte
            epoch += 1
            running[w] = (tid, now, now + dur, epoch)
            inflight.setdefault(tid, set()).add(w)
            if speculative:
                res.n_speculative += 1
            push(now + dur, "finish", (w, tid, epoch))

        def try_acquire(w: int, now: float) -> bool:
            if driver_down:
                return False    # no driver, no dispatch: survivors finish
                # what they hold and idle until re-adoption
            if w in running or w not in alive or w in partitioned:
                return False
            # 1. own deque (LIFO — classic work-stealing owner end)
            if deques[w]:
                tid = deques[w].popleft()
                if ready_p(tid):
                    start_task(w, tid, now)
                    return True
                return try_acquire(w, now)   # stale entry; keep looking
            # 2. central overflow
            while central:
                entry = heapq.heappop(central)
                tid = entry[-1]
                if ready_p(tid):
                    start_task(w, tid, now)
                    return True
            # 3. steal from the most-loaded victim (FIFO end)
            victim = None if not self.allow_steal else \
                max((v for v in alive
                     if v != w and v not in partitioned and deques[v]),
                    key=lambda v: len(deques[v]), default=None)
            if victim is not None:
                tid = deques[victim].pop()
                if ready_p(tid):
                    res.n_steals += 1
                    start_task(w, tid, now + self.steal_latency)
                    return True
                return try_acquire(w, now)
            # 4. speculation: duplicate the longest-overdue running task
            # (the pick itself is the shared pick_speculation policy, so
            # the real ClusterExecutor makes the identical choice)
            if self.speculate_after is not None:
                overdue_view = {
                    tid: (now - st, g.nodes[tid].cost)  # nominal speed 1.0
                    for v, (tid, st, en, _) in running.items()
                    if len(inflight.get(tid, ())) == 1}
                cand = pick_speculation(overdue_view, self.speculate_after)
                if cand is not None:
                    start_task(w, cand, now, speculative=True)
                    res.speculated.add(cand)
                    return True
            return False

    # -- failure → lineage recovery (pure tasks recomputed from survivors) --
        def handle_failure(w: int, now: float) -> None:
            res.n_failures += 1
            alive.discard(w)
            lost_running = running.pop(w, None)
            if lost_running is not None:
                tid = lost_running[0]
                inflight.get(tid, set()).discard(w)
                # the in-flight task dies with the worker; unless a
                # speculative twin still runs it elsewhere, put it back
                if tid not in done and not inflight.get(tid):
                    heapq.heappush(central, (*self._prio(tid), tid))
            # orphan this worker's queued tasks into the central queue
            while deques[w]:
                tid = deques[w].pop()
                heapq.heappush(central, (*self._prio(tid), tid))
            del deques[w]
            # results held only by w are lost unless durable
            lost: Set[int] = set()
            for tid, holders in results_at.items():
                holders.discard(w)
                if not holders:
                    lost.add(tid)
            if not lost:
                return
            # lineage: a lost result must be recomputed iff some not-done
            # task (or a driver output) still needs it
            needed: Set[int] = set(g.outputs)
            for t in pending:
                needed.update(g.nodes[t].all_deps)
            to_redo = {t for t in lost if t in needed or t in g.outputs}
            # recompute transitively: ancestors of to_redo that are also lost
            frontier = set(to_redo)
            while frontier:
                t = frontier.pop()
                for d in g.nodes[t].all_deps:
                    if d in lost and d not in to_redo:
                        to_redo.add(d)
                        frontier.add(d)
            for t in to_redo:
                results_at.pop(t, None)
                done.discard(t)
                pending.add(t)
                res.n_recomputed += 1
            for t in sorted(to_redo):
                if ready_p(t):
                    heapq.heappush(central, (*self._prio(t), t))

        # seed: all zero-dep tasks round-robin across workers
        sources = [tid for tid in g.topo_order()
                   if not g.nodes[tid].all_deps]
        sources.sort(key=self._prio)
        for i, tid in enumerate(sources):
            deques[i % self.n_workers].append(tid)

        now = 0.0
        for w in list(alive):
            try_acquire(w, now)

        while evq:
            now, _, kind, data = heapq.heappop(evq)
            if kind == "finish":
                w, tid, ep = data
                cur = running.get(w)
                if cur is None or cur[3] != ep:
                    continue   # stale (worker failed / task re-assigned)
                if w in partitioned:
                    # the worker finished, but the driver can't see it:
                    # the completion buffers until the partition heals
                    # (or is discarded by a grace-expiry death)
                    push(partitioned[w], "finish", (w, tid, ep))
                    continue
                del running[w]
                inflight.get(tid, set()).discard(w)
                busy[w] = busy.get(w, 0.0) + (now - cur[1])
                if tid in done:
                    pass       # a speculative twin already finished
                else:
                    done.add(tid)
                    pending.discard(tid)
                    results_at.setdefault(tid, set()).add(w)
                    res.task_worker[tid] = w
                    node = g.nodes[tid]
                    if node.kind is TaskKind.BARRIER:
                        # checkpoint: node + its direct inputs become durable
                        results_at.setdefault(tid, set()).add(DURABLE)
                        for d in node.deps:
                            results_at.setdefault(d, set()).add(DURABLE)
                    enqueue_ready_from(tid, w)
                    res.makespan = max(res.makespan, now)
                    if self._model is not None:
                        # same observation + trigger predicate the live
                        # driver applies in on_done/maybe_refuse
                        mg = self.member_graph
                        ms = self.plan.members.get(tid, (tid,))
                        self._model.observe(
                            max(node.cost, 1e-9), now - cur[1],
                            fn_units=[(fn_key(mg.nodes[m]),
                                       mg.nodes[m].cost)
                                      for m in ms if m in mg.nodes])
                        n_frontier = sum(1 for t in pending
                                         if not inflight.get(t))
                        if refusion_due(self._model, self._governor,
                                        n_frontier):
                            self._governor.note_fired(self._model)
                            res.refusions += 1
                            res.refusion_times.append(now)
                            res.timeline.append((now, "refusion trigger"))
                try_acquire(w, now)
                # a finish may unblock work for idle peers
                for v in list(alive):
                    if v not in running:
                        try_acquire(v, now)
            elif kind == "fail":
                w, _ = data
                if w in alive:
                    handle_failure(w, now)
                    res.timeline.append((now, f"fail w{w}"))
                    for v in list(alive):
                        if v not in running:
                            try_acquire(v, now)
            elif kind == "join":
                w, _ = data
                if w not in alive:
                    alive.add(w)
                    deques[w] = deque()
                    busy.setdefault(w, 0.0)
                    self.speed.setdefault(w, 1.0)
                    res.timeline.append((now, f"join w{w}"))
                    try_acquire(w, now)
            elif kind == "slow":
                w, factor = data
                if w in self.speed:
                    self.speed[w] *= factor
                    res.timeline.append((now, f"slow w{w} ×{factor}"))
            elif kind == "partition":
                w, dur = data
                if w in alive and w not in partitioned:
                    heal_t = now + dur
                    partitioned[w] = heal_t
                    res.n_suspected += 1
                    res.timeline.append((now, f"partition w{w} {dur:g}s"))
                    if dur > self.suspect_grace:
                        # the driver will give up first: a false death at
                        # grace expiry, then an empty-handed rejoin at heal
                        push(now + self.suspect_grace,
                             "partition_expire", (w, heal_t))
                    else:
                        push(heal_t, "partition_heal", (w,))
            elif kind == "partition_heal":
                (w,) = data
                if w in partitioned:
                    partitioned.pop(w)
                    res.n_healed += 1
                    res.timeline.append((now, f"heal w{w}"))
                    # buffered finishes for w fire at this same timestamp
                    # (pushed behind this event); idle peers may also have
                    # work for it now
                    try_acquire(w, now)
            elif kind == "partition_expire":
                w, heal_t = data
                if w in partitioned:
                    # suspect_grace ran out mid-partition: the driver
                    # declares a LIVE worker dead — sole-copy values replay
                    # through lineage (the phantom recovery cost a longer
                    # grace would have avoided), and the worker rejoins
                    # empty when the partition actually heals
                    partitioned.pop(w)
                    res.n_false_deaths += 1
                    if w in alive:
                        handle_failure(w, now)
                        res.timeline.append((now, f"false death w{w}"))
                    push(heal_t, "join", (w, 1.0))
                    for v in list(alive):
                        if v not in running:
                            try_acquire(v, now)
            elif kind == "driver_kill":
                driver_down = True
                res.timeline.append((now, "driver killed"))
                # workers that die WITH the driver are confirmed losses at
                # resume — one handle_failure each folds into the single
                # reconciliation pass (their requeued work sits in the
                # central queue until dispatch unblocks)
                for w in self.driver_dead_workers:
                    if w in alive:
                        handle_failure(w, now)
                        res.timeline.append((now, f"fail w{w} (outage)"))
            elif kind == "driver_resume":
                driver_down = False
                res.timeline.append((now, "driver resumed"))
                for v in list(alive):
                    if v not in running:
                        try_acquire(v, now)

        if pending:
            n_ready = sum(1 for t in pending if ready_p(t))
            frontier = [t for t in sorted(pending)
                        if all(d in done or d not in pending
                               for d in g.nodes[t].all_deps)][:5]
            detail = {t: {"inflight": sorted(inflight.get(t, ())),
                          "missing_deps": [d for d in g.nodes[t].all_deps
                                           if d not in done]}
                      for t in frontier}
            raise RuntimeError(
                f"simulation deadlocked with {len(pending)} tasks pending "
                f"({n_ready} ready; alive={sorted(alive)}; "
                f"running={ {w: r[0] for w, r in running.items()} }; "
                f"deques={ {w: len(d) for w, d in deques.items() if d} }; "
                f"central={len(central)}; frontier={detail})")
        res.busy_time = busy
        return res


def simulate(graph: TaskGraph, n_workers: int, **kw) -> SimResult:
    return ClusterSim(graph, n_workers, **kw).run()


#: knobs search_policy knows how to sweep, and the sim parameter each maps
#: to.  Fusion-shape knobs go through ``fuse_kw`` so each candidate prices
#: a different REGROUPING of the same graph.
SEARCHABLE_POLICIES = ("suspect_grace", "collective_arity",
                       "speculate_after", "keep_parallelism",
                       "fanin_cost", "group_cost")


def search_policy(
    name: str,
    graph: TaskGraph,
    n_workers: int,
    candidates: List,
    *,
    events: Optional[List[WorkerEvent]] = None,
    trace: Optional[RunTrace] = None,
    **kw,
):
    """One front door for every offline policy search.

    Sweeps ``candidates`` for the named knob over the same scenario and
    returns ``(best, results)``.  ``trace`` (a recorded
    :class:`repro_torch.core.adaptive.RunTrace`, e.g. a live run's
    ``ClusterExecutor.last_trace``) replays *measured* per-member
    durations instead of declared costs — that is what closes the loop
    from runtime measurement back to offline search: candidates are
    priced against what the cluster actually did, and the winner feeds
    straight back into ``ClusterConfig``.

    Knobs and tie-breaks (all minimize makespan first):

    ``suspect_grace``      fewer recomputes, then the smaller grace
                           (requires partition ``events``)
    ``collective_arity``   the larger arity (shallower tree)
    ``speculate_after``    fewer speculative twins, then the smaller
                           threshold
    ``keep_parallelism`` / ``fanin_cost`` / ``group_cost``
                           the smaller candidate; swept through
                           ``fuse_kw`` (``fuse`` defaults to ``"auto"``
                           for these so the knob has something to shape)
    """
    if name not in SEARCHABLE_POLICIES:
        raise ValueError(f"unknown policy knob {name!r}; searchable: "
                         f"{SEARCHABLE_POLICIES}")
    if not candidates:
        noun = {"suspect_grace": "grace",
                "collective_arity": "arity"}.get(name, name)
        raise ValueError(f"need at least one candidate {noun}")
    if name == "suspect_grace" and events is None:
        raise ValueError("suspect_grace search needs partition events")
    if trace is not None:
        kw["trace"] = trace
    if name in ("keep_parallelism", "fanin_cost", "group_cost"):
        kw.setdefault("fuse", "auto")
    results: Dict = {}
    for cand in candidates:
        ckw = dict(kw)
        if events is not None:
            ckw["events"] = list(events)
        if name == "suspect_grace":
            ckw["suspect_grace"] = cand
        elif name == "collective_arity":
            if parse_collectives_spec(cand) == "off":
                raise ValueError(f"candidate arity {cand} is not a tree")
            ckw["collectives"] = cand
        elif name == "speculate_after":
            ckw["speculate_after"] = cand
        else:
            fkw = dict(ckw.pop("fuse_kw", None) or {})
            fkw[name] = int(cand) if name == "keep_parallelism" else cand
            ckw["fuse_kw"] = fkw
        results[cand] = simulate(graph, n_workers, **ckw)
    if name == "suspect_grace":
        def key(c):
            return (results[c].makespan, results[c].n_recomputed, c)
    elif name == "collective_arity":
        def key(c):
            return (results[c].makespan, -c)
    elif name == "speculate_after":
        def key(c):
            return (results[c].makespan, results[c].n_speculative, c)
    else:
        def key(c):
            return (results[c].makespan, c)
    best = min(results, key=key)
    return best, results


def search_suspect_grace(
    graph: TaskGraph,
    n_workers: int,
    candidates: List[float],
    *,
    events: List[WorkerEvent],
    **kw,
) -> Tuple[float, Dict[float, SimResult]]:
    """Offline policy search for the executor's ``suspect_grace`` knob.

    Replays the same partition scenario (``events`` with ``"partition"``
    entries; ``factor`` = outage seconds) under each candidate grace and
    returns ``(best, results)``.  Too short a grace converts transient
    partitions into false deaths and phantom recomputation
    (:func:`repro_torch.core.lineage.phantom_recovery_cost` is the per-event
    analytic form); too long a grace leaves the pool waiting on a worker
    that really is dead.  ``best`` minimizes makespan, ties broken toward
    fewer recomputes, then the *smaller* grace (detect true deaths
    sooner).  Feed the winner straight to
    ``ClusterExecutor(suspect_grace=...)``.  Thin wrapper over
    :func:`search_policy` (same candidates, scenario, and tie-breaks).
    """
    return search_policy("suspect_grace", graph, n_workers, candidates,
                         events=events, **kw)


def search_collective_arity(
    graph: TaskGraph,
    n_workers: int,
    candidates: List[int],
    **kw,
) -> Tuple[int, Dict[int, SimResult]]:
    """Offline policy search for the collective tree arity
    (``ClusterExecutor(collectives=<arity>)`` / ``--collectives N``).

    Re-lowers the SAME traced graph under each candidate arity (the
    ``collectives`` integer spec overrides every node's traced arity) and
    simulates it: a small arity makes the tree deep (more staged hops,
    more dispatch overheads on the critical path), a large arity makes
    each stage wide (one stage serializes many combines and a single
    slow input stalls more of the tree).  The sweet spot depends on
    ``n_workers``, ``dispatch_overhead``, and ``comm_per_byte`` — i.e.
    on the machine, which is why this is a searched knob and not a
    constant (the ``hillclimb``/``search_suspect_grace`` pattern;
    ROADMAP item 4).  ``best`` minimizes makespan, ties toward the
    larger arity (shallower tree ⇒ fewer dispatches at equal makespan).
    Thin wrapper over :func:`search_policy`.
    """
    return search_policy("collective_arity", graph, n_workers, candidates,
                         **kw)

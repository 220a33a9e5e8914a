"""Plan-time graph compilation: fuse the task DAG into *super-tasks*.

Port of ``repro/core/fusion.py``, unchanged: fusion is plain Python.

The paper's purity guarantee means the runtime may rewrite the task graph
freely — results are a function of the graph alone, not of how it is cut
into dispatch units.  BENCH_multihost measured ~0.78 ms of control-plane
overhead per task on TCP, so a fine-grained graph (many small pure
functions — the paper's natural programming style) is *driver-bound*: the
cluster spends its time round-tripping ``run``/``done`` messages, not
computing.  Following Mapple's framing (mapping/granularity decisions
belong in a compilation pass over the graph, not in the per-task dispatch
loop), this module compiles the DAG **before** dispatch:

* :func:`fuse` clusters the graph into super-tasks and returns a
  :class:`FusedPlan` — the member-level graph, a *cluster-level*
  :class:`~repro_torch.core.graph.TaskGraph` (``cgraph``) the scheduler and the
  driver state machine run over, and the member/boundary index maps the
  runtime needs (which values cross cluster edges, which stay private).
* A super-task is dispatched as **one** control message; the worker runs
  its members locally in topo order and only *cluster outputs* (values
  some other cluster, or the driver, will read) are kept/published.
* ``--fuse off`` produces the **identity plan**: ``cgraph`` *is* the
  original graph and cluster ids equal task ids, so fused and unfused
  execution share a single driver code path.

What fuses (all rules are deterministic, so every process that computes a
plan from the same graph and spec agrees):

1. **Single-consumer contraction** (chains and converging trees): a
   cluster whose members' only external successors live in one cluster
   ``Y`` is merged into ``Y``.  Contracting an out-degree-1 cluster into
   its sole successor can never create a cycle and — for a strict linear
   link (``Y``'s only external producer is ``X``) — can never lose
   parallelism either, so strict chains fuse regardless of cost; a
   *fan-in* merge (``Y`` has other producers) is gated by ``fanin_cost``
   because the absorbed producer could otherwise have overlapped with
   ``Y``'s other inputs.
2. **Sibling grouping** (wide maps): clusters at the same topo depth with
   identical dependency signatures (equal depth ⇒ no path between them ⇒
   merging is cycle-safe) are packed into groups, bounded by
   ``group_cost``/``max_members`` and floored at ``keep_parallelism``
   groups so a wide map still feeds every worker.

``BARRIER`` and ``EFFECTFUL`` nodes never fuse (a barrier is a lineage
cut, and replaying half-fused IO at recovery would duplicate effects);
``PURE`` and ``PROJECTION`` nodes do.  ``COLLECTIVE`` nodes — the staged
tree hops :func:`repro_torch.core.collectives.lower_collectives` emits — are
**cluster boundaries** too: each hop must stay its own dispatch unit so
sibling stages of one tree level run on different workers in parallel,
and a SIGKILL'd mid-tree aggregator replays as exactly one cluster
(its subtree), never as part of an absorbed producer chain.  Their
fan-in costing is shape-aware by construction: lowering prices each
stage at ``root_cost × width / n`` (width <= the tree arity), so the
cost gates here and the scheduler's EFT term see per-hop work, never
the original N-wide fan-in (docs/collectives.md).

This is the runtime sibling of :func:`repro_torch.core.tracing.fuse_cheap_chains`
(a trace-time rewrite that composes Python callables and *erases* member
identity).  The runtime pass must keep members addressable — lineage
recovery, differential tests, and ``run(graph)``'s ``{tid: value}``
contract all speak member task ids — so it fuses at the *plan* level and
leaves the graph untouched.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple, Union

from .graph import GraphError, TaskGraph, TaskKind, TaskNode

#: kinds that may share a cluster with other members.  COLLECTIVE is
#: deliberately absent: a lowered collective stage is a cluster boundary
#: (parallel tree levels + subtree-bounded recovery — module docstring)
FUSABLE_KINDS = (TaskKind.PURE, TaskKind.PROJECTION)

DEFAULT_MAX_MEMBERS = 32        # member cap per super-task
DEFAULT_FANIN_COST = 8.0        # cost cap for non-chain (fan-in) merges
DEFAULT_GROUP_COST = 8.0        # cost cap per sibling group
DEFAULT_KEEP_PARALLELISM = 8    # sibling groups never packed below this

FuseSpec = Union[None, bool, int, str]


def parse_fuse_spec(spec: FuseSpec):
    """Normalize a user-facing fuse spec to ``"off"`` | ``"auto"`` | int.

    Accepts the launcher vocabulary (``--fuse {auto,off,N}``), booleans,
    and ``None`` (off).  ``N`` caps cluster size at ``N`` members with the
    auto rules; ``N <= 1`` is the identity (a one-member cluster per task).
    """
    if spec is None or spec is False:
        return "off"
    if spec is True:
        return "auto"
    if isinstance(spec, int) and not isinstance(spec, bool):
        return "off" if spec <= 1 else spec
    if isinstance(spec, str):
        s = spec.strip().lower()
        if s in ("off", "none", "0", "1"):
            return "off"
        if s == "auto":
            return "auto"
        try:
            n = int(s)
        except ValueError:
            raise ValueError(
                f"unknown fuse spec {spec!r} (expected 'auto', 'off', or a "
                f"max-members integer)") from None
        return "off" if n <= 1 else n
    raise ValueError(f"unknown fuse spec {spec!r}")


@dataclasses.dataclass
class WorkerFusionView:
    """The per-run slice of a plan a worker needs to execute super-tasks:
    which member tids each cluster id runs (topo order) and which of them
    to keep in the local store (cluster outputs plus driver-required
    values).  Plain dicts of int tuples — a few bytes per task — so it
    ships in spawn args and TCP welcome frames alike."""

    members: Dict[int, Tuple[int, ...]]
    keep: Dict[int, Tuple[int, ...]]


@dataclasses.dataclass
class FusedPlan:
    """The compiled execution plan for one graph.

    ``cgraph`` is a real :class:`TaskGraph` over cluster ids (topo-ordered,
    ``fn=None``, cost/out_bytes aggregated), so the scheduler, the
    simulator, and the driver's critical-path machinery run on it
    unchanged — and its comm-cost terms see only **cross-cluster** edges.
    For the identity plan ``cgraph is graph`` and every map is trivial,
    which is what keeps ``--fuse off`` byte-identical to the pre-fusion
    runtime.
    """

    graph: TaskGraph                          # member-level graph
    cgraph: TaskGraph                         # cluster-level graph
    members: Dict[int, Tuple[int, ...]]       # cid -> member tids (topo)
    cluster_of: Dict[int, int]                # member tid -> cid
    outputs: Dict[int, Tuple[int, ...]]       # cid -> externally read values
    ext_deps: Dict[int, Tuple[int, ...]]      # cid -> external input values
    consumers: Dict[int, Tuple[int, ...]]     # value -> consuming cids (ext)
    spec: Any = "off"

    @property
    def identity(self) -> bool:
        return self.cgraph is self.graph

    @property
    def n_clusters(self) -> int:
        return len(self.cgraph.nodes)

    @property
    def n_fused(self) -> int:
        """Tasks that no longer cost a dispatch round-trip."""
        return len(self.graph.nodes) - len(self.cgraph.nodes)

    def worker_view(self, required: Iterable[int]) -> WorkerFusionView:
        """Build the worker-facing slice.  ``required`` is the set of
        member values the driver must materialize at the end of the run
        (all tasks, or just ``graph.outputs`` under ``outputs_only``).
        The identity plan keeps everything — exactly the pre-fusion worker
        behavior — while a real plan keeps only boundary values."""
        if self.identity:
            return WorkerFusionView(dict(self.members), dict(self.members))
        req = set(required)
        keep = {
            cid: tuple(m for m in ms
                       if m in req or m in self._outset[cid])
            for cid, ms in self.members.items()
        }
        return WorkerFusionView(dict(self.members), keep)

    def __post_init__(self) -> None:
        self._outset: Dict[int, Set[int]] = {
            cid: set(vs) for cid, vs in self.outputs.items()}

    def summary(self) -> str:
        sizes = [len(m) for m in self.members.values()]
        return (f"FusedPlan(tasks={len(self.graph.nodes)}, "
                f"clusters={self.n_clusters}, fused={self.n_fused}, "
                f"max_cluster={max(sizes, default=0)})")


def identity_plan(graph: TaskGraph) -> FusedPlan:
    """One cluster per task, cluster id == task id, ``cgraph is graph``."""
    members = {t: (t,) for t in graph.nodes}
    succ = graph.successors()
    return FusedPlan(
        graph=graph,
        cgraph=graph,
        members=members,
        cluster_of={t: t for t in graph.nodes},
        outputs=dict(members),
        ext_deps={t: n.all_deps for t, n in graph.nodes.items()},
        consumers={t: tuple(succ[t]) for t in graph.nodes},
        spec="off",
    )


def offset_plan(plan: FusedPlan, base: int, off_graph: TaskGraph) -> FusedPlan:
    """Rebase a job-local :class:`FusedPlan` by ``+base`` onto ``off_graph``
    (the job's graph already shifted by :func:`repro_torch.core.tracing.offset_graph`).

    Jobs submitted to a resident executor are fused in their own pristine
    0-based space — the fusion rules are deterministic over *that* graph —
    and then transplanted into the executor's union namespace, where both
    cluster ids and member tids live in the job's ``[base, base + n)``
    range.  An identity job plan stays identity (``cgraph is off_graph``),
    so unfused jobs keep the single driver code path.
    """
    if plan.identity:
        cgraph = off_graph
    else:
        cgraph = TaskGraph()
        for cid in sorted(plan.cgraph.nodes):
            n = plan.cgraph.nodes[cid]
            meta = dict(n.meta)
            if "members" in meta:
                meta["members"] = tuple(m + base for m in meta["members"])
            cgraph.nodes[cid + base] = dataclasses.replace(
                n,
                tid=cid + base,
                deps=tuple(d + base for d in n.deps),
                token_deps=tuple(d + base for d in n.token_deps),
                meta=meta,
            )
        cgraph.outputs = [o + base for o in plan.cgraph.outputs]
        cgraph._next_id = base + (max(plan.cgraph.nodes) + 1
                                  if plan.cgraph.nodes else 0)
    return FusedPlan(
        graph=off_graph,
        cgraph=cgraph,
        members={c + base: tuple(m + base for m in ms)
                 for c, ms in plan.members.items()},
        cluster_of={m + base: c + base for m, c in plan.cluster_of.items()},
        outputs={c + base: tuple(v + base for v in vs)
                 for c, vs in plan.outputs.items()},
        ext_deps={c + base: tuple(v + base for v in vs)
                  for c, vs in plan.ext_deps.items()},
        consumers={v + base: tuple(c + base for c in cs)
                   for v, cs in plan.consumers.items()},
        spec=plan.spec,
    )


class _UnionFind:
    def __init__(self, ids: Iterable[int]) -> None:
        self.parent = {i: i for i in ids}

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:          # path compression
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int) -> int:
        """Merge ``a``'s set into ``b``'s root; returns the surviving root."""
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb
        return rb


def fuse(
    graph: TaskGraph,
    spec: FuseSpec = "auto",
    *,
    max_members: Optional[int] = None,
    fanin_cost: float = DEFAULT_FANIN_COST,
    group_cost: float = DEFAULT_GROUP_COST,
    keep_parallelism: int = DEFAULT_KEEP_PARALLELISM,
) -> FusedPlan:
    """Compile ``graph`` into a :class:`FusedPlan` (see module docstring).

    Deterministic: equal ``(graph, spec, knobs)`` always produce an equal
    plan, so the driver and every worker can each compute it locally and
    agree on cluster ids without shipping the plan itself.
    """
    mode = parse_fuse_spec(spec)
    graph.validate()
    if mode == "off" or len(graph.nodes) <= 1:
        return identity_plan(graph)
    cap = max_members if max_members is not None else (
        mode if isinstance(mode, int) else DEFAULT_MAX_MEMBERS)
    cap = max(1, cap)

    succ = graph.successors()
    order = graph.topo_order()
    uf = _UnionFind(graph.nodes)
    # per-root aggregates (only valid at the current root of each set)
    cost = {t: graph.nodes[t].cost for t in graph.nodes}
    size = {t: 1 for t in graph.nodes}
    roster: Dict[int, List[int]] = {t: [t] for t in graph.nodes}
    fusable = {t: graph.nodes[t].kind in FUSABLE_KINDS for t in graph.nodes}

    def merge(a: int, b: int) -> None:
        """Union root ``a`` into root ``b``, folding aggregates."""
        if a == b:
            return
        root = uf.union(a, b)
        gone = a if root == b else b
        cost[root] = cost[a] + cost[b]
        size[root] = size[a] + size[b]
        roster[root].extend(roster.pop(gone))
        fusable[root] = fusable[a] and fusable[b]

    def dep_roots(root: int) -> Set[int]:
        out = set()
        for m in roster[root]:
            for d in graph.nodes[m].all_deps:
                r = uf.find(d)
                if r != root:
                    out.add(r)
        return out

    # --- phase A: single-consumer contraction (reverse topo: sinks first,
    # so a chain collapses transitively in one pass) -----------------------
    for tid in reversed(order):
        x = uf.find(tid)
        if not fusable[x]:
            continue
        ext = {uf.find(s) for s in succ[tid]} - {x}
        if len(ext) != 1:
            continue        # a sink, or fans out to several clusters
        (y,) = ext
        if not fusable[y] or size[x] + size[y] > cap:
            continue
        # a strict linear link (Y's only producer is X) is serial either
        # way — fuse at any cost; a fan-in merge steals overlap, so gate it
        if dep_roots(y) != {x} and cost[x] + cost[y] > fanin_cost:
            continue
        merge(x, y)

    # --- phase B: sibling grouping (same depth + same dep signature ⇒ no
    # path between them ⇒ merging is cycle-safe) ---------------------------
    roots = sorted(roster, key=lambda r: min(roster[r]))
    depth: Dict[int, int] = {}              # cluster depth in the cluster DAG
    for tid in order:
        r = uf.find(tid)
        for dep in graph.nodes[tid].all_deps:
            rd = uf.find(dep)
            if rd != r:
                depth[r] = max(depth.get(r, 0), depth.get(rd, 0) + 1)
        depth.setdefault(r, 0)
    buckets: Dict[Tuple, List[int]] = {}
    for r in roots:
        if not fusable[r]:
            continue
        sig = (depth[r], tuple(sorted(min(roster[d]) for d in dep_roots(r))))
        buckets.setdefault(sig, []).append(r)
    # the parallelism floor is per topo DEPTH, not per signature bucket: a
    # wide map whose members fan in from rotating producer pairs splits
    # into many small buckets, and each alone would refuse to pack — but
    # what feeds the workers is the total cluster count at that depth
    depth_total: Dict[int, int] = {}
    for (d, _), grp in buckets.items():
        depth_total[d] = depth_total.get(d, 0) + len(grp)
    for sig in sorted(buckets):
        group = buckets[sig]
        per_group = depth_total[sig[0]] // max(1, keep_parallelism)
        if per_group < 2:
            continue                        # packing would eat parallelism
        acc: List[int] = []
        for r in group:
            r = uf.find(r)
            if acc and (len(acc) >= per_group
                        or size[uf.find(acc[0])] + size[r] > cap
                        or cost[uf.find(acc[0])] + cost[r] > group_cost):
                acc = []
            if acc:
                merge(r, uf.find(acc[0]))
            acc.append(r)

    return _build_plan(graph, uf, spec=mode)


def _build_plan(graph: TaskGraph, uf: _UnionFind, spec: Any) -> FusedPlan:
    """Topo-number the clusters and materialize the cluster-level graph."""
    groups: Dict[int, List[int]] = {}
    for tid in sorted(graph.nodes):
        # ascending task id IS topo order within a cluster (a dep's id is
        # always smaller than its consumer's), so members execute in id
        # order on the worker
        groups.setdefault(uf.find(tid), []).append(tid)

    # cluster DAG topo order, min-member heap tie-break: for all-singleton
    # plans this reproduces task-id order, so cid == tid when nothing fused
    root_deps: Dict[int, Set[int]] = {}
    root_succ: Dict[int, Set[int]] = {}
    for r, ms in groups.items():
        deps = set()
        for m in ms:
            for d in graph.nodes[m].all_deps:
                rd = uf.find(d)
                if rd != r:
                    deps.add(rd)
        root_deps[r] = deps
        for d in deps:
            root_succ.setdefault(d, set()).add(r)
    indeg = {r: len(ds) for r, ds in root_deps.items()}
    ready = [(min(groups[r]), r) for r, d in indeg.items() if d == 0]
    heapq.heapify(ready)
    root_order: List[int] = []
    while ready:
        _, r = heapq.heappop(ready)
        root_order.append(r)
        for s in root_succ.get(r, ()):
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(ready, (min(groups[s]), s))
    if len(root_order) != len(groups):      # pragma: no cover — defensive
        raise GraphError("fusion produced a cyclic cluster graph")

    cid_of_root = {r: i for i, r in enumerate(root_order)}
    cluster_of = {m: cid_of_root[r] for r, ms in groups.items() for m in ms}
    members = {cid_of_root[r]: tuple(ms) for r, ms in groups.items()}
    out_set = set(graph.outputs)

    cgraph = TaskGraph()
    outputs: Dict[int, Tuple[int, ...]] = {}
    ext_deps: Dict[int, Tuple[int, ...]] = {}
    consumers: Dict[int, List[int]] = {}
    succ = graph.successors()
    for r in root_order:
        cid = cid_of_root[r]
        ms = groups[r]
        nodes = [graph.nodes[m] for m in ms]
        deps: Set[int] = set()
        token_deps: Set[int] = set()
        evals: Set[int] = set()
        for n in nodes:
            for d in n.deps:
                if cluster_of[d] != cid:
                    deps.add(cluster_of[d])
                    evals.add(d)
            for d in n.token_deps:
                if cluster_of[d] != cid:
                    token_deps.add(cluster_of[d])
                    evals.add(d)
        token_deps -= deps
        outs = tuple(m for m in ms
                     if m in out_set
                     or any(cluster_of[s] != cid for s in succ[m]))
        outputs[cid] = outs
        ext_deps[cid] = tuple(sorted(evals))
        for v in sorted(evals):
            consumers.setdefault(v, []).append(cid)
        name = (nodes[0].name if len(nodes) == 1
                else f"{nodes[0].name}+{len(nodes) - 1}")
        kind = nodes[0].kind if len(nodes) == 1 else TaskKind.PURE
        got = cgraph.add_node(
            name, None, (), {}, kind,
            deps=tuple(sorted(deps)),
            token_deps=tuple(sorted(token_deps)),
            cost=sum(n.cost for n in nodes),
            out_bytes=sum(graph.nodes[m].out_bytes for m in outs),
            meta={"members": tuple(ms)},
        )
        assert got == cid
    seen_out = set()
    for o in graph.outputs:
        c = cluster_of[o]
        if c not in seen_out:
            seen_out.add(c)
            cgraph.mark_output(c)
    cgraph.validate()
    return FusedPlan(
        graph=graph, cgraph=cgraph, members=members, cluster_of=cluster_of,
        outputs=outputs, ext_deps=ext_deps,
        consumers={v: tuple(cs) for v, cs in consumers.items()},
        spec=spec,
    )


# ---------------------------------------------------------------------------
# Mid-run re-fusion (profile-guided adaptive replanning — docs/adaptive.md)
# ---------------------------------------------------------------------------

def refuse_frontier(
    plan: FusedPlan,
    frontier: Iterable[int],
    *,
    spec: FuseSpec = "auto",
    cost_of=None,
    fanin_cost: float = DEFAULT_FANIN_COST,
    group_cost: float = DEFAULT_GROUP_COST,
    keep_parallelism: int = DEFAULT_KEEP_PARALLELISM,
    next_cid: Optional[int] = None,
) -> Optional[Tuple[Tuple[int, ...], List[Tuple[int, Tuple[int, ...]]]]]:
    """Recompute the clustering of ``frontier`` (not-yet-dispatched
    cluster ids of ``plan``) under corrected member costs.

    Builds the frontier *member* subgraph — deps outside the frontier are
    already satisfied (a PENDING/READY cluster's external producers are
    all completed or in flight) and drop out — rescales each member's
    cost through ``cost_of(node)`` (the CostModel's profile correction),
    and runs the ordinary :func:`fuse` pass over it with the calibrated
    gates.  Completed/in-flight clusters are never touched: they are
    simply not in ``frontier``.

    Returns ``(retired, new_clusters)`` where ``retired`` is the sorted
    tuple of replaced frontier cids and ``new_clusters`` the replacement
    ``(cid, member_tids)`` list in cluster-topo order, with fresh ids
    starting at ``next_cid`` — or ``None`` when re-fusion reproduces the
    existing partition (nothing to do).  The result is exactly what the
    run log journals: :func:`splice_plan` applies it both live and on
    ``--resume`` replay.
    """
    graph = plan.graph
    frontier = sorted(frontier)
    old_parts = {frozenset(plan.members[c]) for c in frontier}
    member_ids = sorted(m for c in frontier for m in plan.members[c])
    mset = set(member_ids)
    sub = TaskGraph()
    for m in member_ids:
        n = graph.nodes[m]
        sub.nodes[m] = dataclasses.replace(
            n,
            deps=tuple(d for d in n.deps if d in mset),
            token_deps=tuple(d for d in n.token_deps if d in mset),
            cost=float(cost_of(n)) if cost_of is not None else n.cost,
            meta=dict(n.meta),
        )
    sub._next_id = member_ids[-1] + 1 if member_ids else 0
    sub.outputs = [m for m in member_ids if m in set(graph.outputs)]
    subplan = fuse(sub, spec, fanin_cost=fanin_cost, group_cost=group_cost,
                   keep_parallelism=keep_parallelism)
    new_parts = {frozenset(ms) for ms in subplan.members.values()}
    if new_parts == old_parts:
        return None
    if next_cid is None:
        next_cid = max(plan.cgraph.nodes, default=-1) + 1
    # sub-plan cids are topo-numbered (identity sub-plans use member tids,
    # also topo), so enumerating them sorted keeps new ids topo-ordered —
    # a new cluster's id is always greater than its new-cluster deps'
    new_clusters = [(next_cid + i, tuple(subplan.members[c]))
                    for i, c in enumerate(sorted(subplan.members))]
    return tuple(frontier), new_clusters


def splice_plan(plan: FusedPlan, retired: Iterable[int],
                new_clusters: List[Tuple[int, Tuple[int, ...]]],
                ) -> Dict[int, int]:
    """Apply one re-fusion decision to ``plan`` **in place**.

    Deterministic plan surgery over the output of
    :func:`refuse_frontier` (or a journaled copy of it): drop the retired
    cluster ids, install the new memberships, and rebuild every derived
    map — ``cluster_of``, per-cluster ``outputs``/``ext_deps``, the
    ``consumers`` index, and the cluster-level graph nodes — using
    exactly the :func:`_build_plan` rules, so a resumed driver replaying
    the journal reconstructs a bit-identical plan.

    Returns ``{value_tid: consumer_count_delta}`` for every externally
    visible value whose consuming-cluster set changed; the executor folds
    these into the object store's ``consumers_left`` refcounts (a merge
    of two consumers of the same value means one fewer pending read).
    """
    graph = plan.graph
    cgraph = plan.cgraph
    retired = set(retired)
    old_cons_len: Dict[int, int] = {}
    for c in retired:
        for v in plan.ext_deps.get(c, ()):
            old_cons_len.setdefault(v, len(plan.consumers.get(v, ())))
        plan.members.pop(c, None)
        plan.outputs.pop(c, None)
        plan.ext_deps.pop(c, None)
        plan._outset.pop(c, None)
        cgraph.nodes.pop(c, None)
    for cid, ms in new_clusters:
        plan.members[cid] = tuple(ms)
        for m in ms:
            plan.cluster_of[m] = cid
    succ = graph.successors()
    out_set = set(graph.outputs)
    for cid, ms in new_clusters:
        nodes = [graph.nodes[m] for m in ms]
        deps: Set[int] = set()
        token_deps: Set[int] = set()
        evals: Set[int] = set()
        for n in nodes:
            for d in n.deps:
                if plan.cluster_of[d] != cid:
                    deps.add(plan.cluster_of[d])
                    evals.add(d)
            for d in n.token_deps:
                if plan.cluster_of[d] != cid:
                    token_deps.add(plan.cluster_of[d])
                    evals.add(d)
        token_deps -= deps
        outs = tuple(m for m in ms
                     if m in out_set
                     or any(plan.cluster_of[s] != cid for s in succ[m]))
        plan.outputs[cid] = outs
        plan._outset[cid] = set(outs)
        plan.ext_deps[cid] = tuple(sorted(evals))
        for v in evals:
            old_cons_len.setdefault(v, len(plan.consumers.get(v, ())))
        name = (nodes[0].name if len(nodes) == 1
                else f"{nodes[0].name}+{len(nodes) - 1}")
        kind = nodes[0].kind if len(nodes) == 1 else TaskKind.PURE
        cgraph.nodes[cid] = TaskNode(
            tid=cid, name=name, fn=None, args=(), kwargs={}, kind=kind,
            deps=tuple(sorted(deps)),
            token_deps=tuple(sorted(token_deps)),
            cost=sum(n.cost for n in nodes),
            out_bytes=sum(graph.nodes[m].out_bytes for m in outs),
            meta={"members": tuple(ms)},
        )
        cgraph._next_id = max(cgraph._next_id, cid + 1)
    # consumer index: surviving old consumers + the new clusters, by cid
    delta: Dict[int, int] = {}
    for v, old_len in old_cons_len.items():
        cons = [c for c in plan.consumers.get(v, ()) if c not in retired]
        cons += [cid for cid, _ in new_clusters if v in plan.ext_deps[cid]]
        cons = sorted(set(cons))
        plan.consumers[v] = tuple(cons)
        if len(cons) != old_len:
            delta[v] = len(cons) - old_len
    # cluster-graph output marks follow the membership
    seen = {c for c in cgraph.outputs if c not in retired}
    cgraph.outputs = [c for c in cgraph.outputs if c not in retired]
    for o in graph.outputs:
        c = plan.cluster_of[o]
        if c not in seen:
            seen.add(c)
            cgraph.outputs.append(c)
    return delta

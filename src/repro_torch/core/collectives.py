"""Collective operations as first-class graph nodes.

Port of ``repro/core/collectives.py``.  The one change is in the combine
ops: ``max``/``min``/``concat`` of torch tensors use ``torch.maximum``,
``torch.minimum`` and ``torch.cat`` (numpy's functions fail on CUDA
tensors); numpy arrays and Python scalars combine as in the reference.

A wide shuffle or reduction written the paper's way — every consumer
fans in from every producer — compiles to N×M point-to-point edges the
scheduler prices one by one, and BENCH_transfer showed those fan-ins
dominating shuffle cells.  Following "Group Communication Patterns for
High Performance Computing in Scala" (PAPERS.md), this module makes the
*pattern* a node: ``broadcast`` / ``scatter`` / ``gather`` /
``all_reduce`` are traced like any pure task (``TaskKind.COLLECTIVE``),
and :func:`lower_collectives` compiles each one into a **tree of staged
hops** before the fusion pass and the scheduler ever see the graph.

Two invariants make the whole thing safe:

1. **The unlowered node is executable.**  Every collective node carries
   a real ``fn`` computing its dense semantics (``all_reduce`` → a
   deterministic tree fold, ``gather`` → the input tuple, ``broadcast``
   → identity, ``scatter`` → contiguous chunks), so
   ``execute_sequential``, the thread backend, and ``collectives="off"``
   need no changes — the node *is* its own point-to-point fallback.
2. **Bracketing is semantics, fixed at trace time.**  Floating-point
   reduction is not associative, so the *shape* of the combine tree is
   part of the value.  :func:`tree_fold` (the dense fn) and the lowered
   stage nodes share one grouping rule — contiguous ``arity``-sized
   chunks per level, left-fold within a chunk — so the distributed tree
   computes **bit-for-bit** the same value as the oracle, healthy or
   under SIGKILL-triggered lineage replay.  Tuning the arity re-traces
   (or re-lowers) the graph; it never silently changes results between
   backends because both sides read the same ``arity``.

Lowering is a deterministic graph→graph rewrite in the style of
:func:`repro_torch.core.tracing.fuse_cheap_chains`: a NEW graph with re-assigned
ids and an ``old2new`` map (every original tid keeps a semantically
identical node, so ``run()``'s ``{tid: value}`` contract and lineage
tests keep speaking original ids).  Stage nodes are ``COLLECTIVE`` too —
:data:`repro.core.fusion.FUSABLE_KINDS` excludes the kind, so every hop
is its own cluster: tree levels parallelize across workers, and a dead
mid-tree aggregator replays as exactly one cluster
(:func:`repro_torch.core.lineage.recovery_plan_clusters` walks only its
subtree).  See ``docs/collectives.md`` for shapes, the host-leader
topology argument, and when point-to-point still wins.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .graph import GraphError, TaskGraph, TaskKind
from .tracing import RemappedRef, _Project

#: default combine-tree arity: 4 keeps the tree shallow (log4 depth) while
#: each stage's fan-in stays small enough that one slow input does not
#: serialize many (hillclimb/ClusterSim searches per-workload values —
#: see simulator.search_collective_arity)
DEFAULT_ARITY = 4

CollectivesSpec = Union[None, bool, int, str]


def parse_collectives_spec(spec: CollectivesSpec):
    """Normalize a collectives spec to ``"off"`` | ``"auto"`` | int.

    Mirrors :func:`repro.core.fusion.parse_fuse_spec` and the launcher
    vocabulary (``--collectives {auto,off,N}``): ``auto`` lowers with each
    node's traced arity, ``off`` executes the dense fallback node
    point-to-point, an integer ``N >= 2`` overrides the tree arity for
    every collective in the graph.
    """
    if spec is None or spec is False:
        return "off"
    if spec is True:
        return "auto"
    if isinstance(spec, int) and not isinstance(spec, bool):
        if spec < 2:
            raise ValueError(
                f"collectives arity {spec} makes no tree (need >= 2)")
        return spec
    if isinstance(spec, str):
        s = spec.strip().lower()
        if s in ("off", "none"):
            return "off"
        if s == "auto":
            return "auto"
        try:
            n = int(s)
        except ValueError:
            raise ValueError(
                f"unknown collectives spec {spec!r} (expected 'auto', "
                f"'off', or a tree-arity integer >= 2)") from None
        return parse_collectives_spec(n)
    raise ValueError(f"unknown collectives spec {spec!r}")


# --------------------------------------------------------------------------
# combine ops (module-level and picklable: traced graphs ship to spawn-
# started and remote TCP workers — see tracing._Project for the idiom)
# --------------------------------------------------------------------------

def _op_sum(a, b):
    return a + b


# With a tensor ``a``, a number or array ``b`` becomes a tensor on a's device
# first, so torch's type promotion applies as numpy's does in the reference.

def _op_max(a, b):
    if isinstance(a, torch.Tensor):
        return torch.maximum(a, torch.as_tensor(b, device=a.device))
    return np.maximum(a, b) if hasattr(a, "shape") else max(a, b)


def _op_min(a, b):
    if isinstance(a, torch.Tensor):
        return torch.minimum(a, torch.as_tensor(b, device=a.device))
    return np.minimum(a, b) if hasattr(a, "shape") else min(a, b)


def _op_concat(a, b):
    if isinstance(a, torch.Tensor):
        return torch.cat([a, torch.as_tensor(b, device=a.device)])
    if hasattr(a, "shape"):
        return np.concatenate([a, b])
    return a + b


REDUCE_OPS: Dict[str, Callable] = {
    "sum": _op_sum, "max": _op_max, "min": _op_min, "concat": _op_concat,
}


def resolve_op(op: Union[str, Callable]) -> Tuple[str, Callable]:
    """``op`` is a registry name or a picklable binary callable."""
    if callable(op):
        return getattr(op, "__name__", "custom"), op
    if op in REDUCE_OPS:
        return op, REDUCE_OPS[op]
    raise ValueError(f"unknown all_reduce op {op!r} "
                     f"(expected one of {sorted(REDUCE_OPS)} or a callable)")


# --------------------------------------------------------------------------
# the shared tree shape + dense node bodies
# --------------------------------------------------------------------------

def tree_depth(n: int, arity: int) -> int:
    """Combine-tree depth for ``n`` leaves (0 when one stage suffices)."""
    arity = max(2, arity)
    depth = 0
    while n > arity:
        n = math.ceil(n / arity)
        depth += 1
    return depth


def tree_fold(values: Sequence[Any], combine: Callable, arity: int) -> Any:
    """THE reduction bracketing: contiguous ``arity`` chunks per level,
    left-fold inside a chunk, repeat until one value.  The lowered stage
    nodes compute exactly one chunk each, so dense and distributed
    evaluation agree bit-for-bit even for non-associative float ops."""
    vals = list(values)
    if not vals:
        raise ValueError("tree_fold of no values")
    arity = max(2, arity)
    while len(vals) > 1:
        vals = [functools.reduce(combine, vals[i:i + arity])
                for i in range(0, len(vals), arity)]
    return vals[0]


class _ReduceStage:
    """One combine-tree hop: left-fold its (<= arity) inputs.  Doubles as
    the dense ``all_reduce`` body when ``arity`` covers all inputs."""

    __slots__ = ("combine",)

    def __init__(self, combine: Callable):
        self.combine = combine

    def __call__(self, *xs):
        return functools.reduce(self.combine, xs)


class _AllReduceFn:
    """Dense ``all_reduce`` body: the full tree fold (same bracketing the
    lowered stages compute piecewise)."""

    __slots__ = ("combine", "arity")

    def __init__(self, combine: Callable, arity: int):
        self.combine = combine
        self.arity = arity

    def __call__(self, *xs):
        return tree_fold(xs, self.combine, self.arity)


def _gather_leaf(*xs):
    """Leaf gather hop (and the dense ``gather`` body): tuple of inputs."""
    return xs


def _gather_concat(*parts):
    """Inner gather hop: flatten child tuples one level (order preserved,
    so the concatenation of contiguous leaf groups == the dense tuple)."""
    out: List[Any] = []
    for p in parts:
        out.extend(p)
    return tuple(out)


def _identity(x):
    """Broadcast body: every copy IS the value (replication happens in the
    lowered copy tree, not in the function)."""
    return x


def _chunk_bounds(length: int, n: int) -> List[Tuple[int, int]]:
    """``np.array_split`` boundaries: first ``length % n`` chunks get one
    extra element.  Shared by the dense scatter body and the lowered
    per-chunk nodes so both slice identically."""
    base, extra = divmod(length, n)
    bounds = []
    start = 0
    for i in range(n):
        end = start + base + (1 if i < extra else 0)
        bounds.append((start, end))
        start = end
    return bounds


class _ScatterFn:
    """Dense ``scatter`` body: tuple of ``n`` contiguous chunks of the
    leading axis (arrays slice as views; sequences slice as lists)."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n

    def __call__(self, x):
        bounds = _chunk_bounds(len(x), self.n)
        return tuple(x[a:b] for a, b in bounds)


class _ScatterChunk:
    """Lowered scatter hop: chunk ``i`` straight off the source value —
    bit-identical to ``_ScatterFn(n)(x)[i]`` without materializing the
    full tuple on the consumer's worker."""

    __slots__ = ("i", "n")

    def __init__(self, i: int, n: int):
        self.i = i
        self.n = n

    def __call__(self, x):
        a, b = _chunk_bounds(len(x), self.n)[self.i]
        return x[a:b]


# --------------------------------------------------------------------------
# graph-level builders (shared by the tracing API and hand-built graphs)
# --------------------------------------------------------------------------

def _coll_meta(op: str, n: int, arity: int, **extra) -> Dict[str, Any]:
    info = {"op": op, "n": n, "arity": max(2, arity)}
    info.update(extra)
    return {"collective": info}


def add_all_reduce(graph: TaskGraph, dep_tids: Sequence[int],
                   op: Union[str, Callable] = "sum", *,
                   arity: int = DEFAULT_ARITY, name: Optional[str] = None,
                   cost: float = 1.0, out_bytes: int = 0) -> int:
    """Append an ``all_reduce`` node combining ``dep_tids`` (in order)."""
    if not dep_tids:
        raise GraphError("all_reduce needs at least one input")
    op_name, combine = resolve_op(op)
    return graph.add_node(
        name or f"all_reduce[{op_name}]",
        _AllReduceFn(combine, arity),
        tuple(RemappedRef(d) for d in dep_tids), {}, TaskKind.COLLECTIVE,
        deps=tuple(dict.fromkeys(dep_tids)), cost=cost, out_bytes=out_bytes,
        meta=_coll_meta("all_reduce", len(dep_tids), arity, combine=op_name))


def add_gather(graph: TaskGraph, dep_tids: Sequence[int], *,
               arity: int = DEFAULT_ARITY, name: Optional[str] = None,
               cost: float = 1.0, out_bytes: int = 0) -> int:
    """Append a ``gather`` node producing ``tuple(values of dep_tids)``."""
    if not dep_tids:
        raise GraphError("gather needs at least one input")
    return graph.add_node(
        name or "gather", _gather_leaf,
        tuple(RemappedRef(d) for d in dep_tids), {}, TaskKind.COLLECTIVE,
        deps=tuple(dict.fromkeys(dep_tids)), cost=cost, out_bytes=out_bytes,
        meta=_coll_meta("gather", len(dep_tids), arity))


def add_broadcast(graph: TaskGraph, dep_tid: int, *,
                  arity: int = DEFAULT_ARITY, name: Optional[str] = None,
                  cost: float = 0.0, out_bytes: int = 0) -> int:
    """Append a ``broadcast`` node (identity value; the replication tree
    over its consumers is built at lowering time, when they are known)."""
    return graph.add_node(
        name or "broadcast", _identity, (RemappedRef(dep_tid),), {},
        TaskKind.COLLECTIVE, deps=(dep_tid,), cost=cost,
        out_bytes=out_bytes or graph.nodes[dep_tid].out_bytes,
        meta=_coll_meta("broadcast", 1, arity))


def add_scatter(graph: TaskGraph, dep_tid: int, n: int, *,
                arity: int = DEFAULT_ARITY, name: Optional[str] = None,
                cost: float = 0.0, out_bytes: int = 0) -> int:
    """Append a ``scatter`` node splitting ``dep_tid`` into ``n``
    contiguous leading-axis chunks (unpack via projections)."""
    if n < 1:
        raise GraphError("scatter needs n >= 1 chunks")
    return graph.add_node(
        name or f"scatter{n}", _ScatterFn(n), (RemappedRef(dep_tid),), {},
        TaskKind.COLLECTIVE, deps=(dep_tid,), cost=cost,
        out_bytes=out_bytes, meta=_coll_meta("scatter", n, arity))


# --------------------------------------------------------------------------
# the lowering pass
# --------------------------------------------------------------------------

def has_collectives(graph: TaskGraph) -> bool:
    return any(n.kind is TaskKind.COLLECTIVE and "collective" in n.meta
               for n in graph.nodes.values())


def _stage_cost(root_cost: float, width: int, n: int) -> float:
    """Shape-aware stage pricing: a hop combining ``width`` of ``n``
    inputs carries that fraction of the root's traced cost, so the
    scheduler's EFT and fusion's cost gates see per-hop work, never the
    root's full N-wide fan-in."""
    return max(1e-6, root_cost * width / max(1, n))


def lower_collectives(
    graph: TaskGraph, spec: CollectivesSpec = "auto", *,
    reshape_reductions: bool = False,
) -> Tuple[TaskGraph, Optional[Dict[int, int]]]:
    """Compile collective nodes into staged tree hops.

    Returns ``(lowered_graph, old2new)`` — or ``(graph, None)`` (identity,
    the SAME object) when the spec is off or the graph has no collectives,
    which is what keeps every collective-free run byte-identical to the
    pre-collectives runtime.

    Deterministic: equal ``(graph, spec)`` always produce an equal lowered
    graph, so resumed runs re-derive the same node ids and the run log's
    graph fingerprint stays meaningful.

    An integer spec overrides the tree arity — but only for the
    value-preserving shapes (``broadcast`` replication, ``gather``
    concatenation, which produce identical bits at any arity).  An
    ``all_reduce``'s bracketing IS its value (float combines are not
    associative), so its arity is frozen at trace time and a live
    executor never reshapes it: that is what keeps ``--collectives N``
    runs bit-identical to the sequential oracle.  ``ClusterSim`` passes
    ``reshape_reductions=True`` — a simulator prices shapes and never
    looks at values, so the arity search
    (:func:`repro.core.simulator.search_collective_arity`) can model the
    reduce tree at each candidate; feed the winner back as the traced
    ``arity=`` to change real bracketing deliberately.

    Per op (``arity`` = the node's traced arity, or the spec's integer
    override where value-preserving):

    * ``all_reduce`` — contiguous ``arity``-chunks fold per level
      (:func:`tree_fold`'s exact bracketing); each chunk is one
      ``COLLECTIVE`` stage node, the original tid becomes the final fold.
    * ``gather`` — leaf stages tuple their chunk, inner stages concatenate
      child tuples; the original tid concatenates the last level.
    * ``broadcast`` — the original tid stays an identity root; a copy tree
      fans out below it and each consumer is rewired to its assigned copy
      (≤ ``arity`` consumers per copy), so no single worker serves all M
      readers.
    * ``scatter`` — each ``π_i`` projection consumer is rewritten to a
      direct :class:`_ScatterChunk` node on the source, skipping the full
      tuple; the root keeps the dense body for non-projection readers.
      (A scatter is already one value per consumer — point-to-point is
      the optimal shape; see docs/collectives.md.)
    """
    mode = parse_collectives_spec(spec)
    graph.validate()
    if mode == "off" or not has_collectives(graph):
        return graph, None

    succ = graph.successors()
    new = TaskGraph()
    old2new: Dict[int, int] = {}
    # per-consumer dep rewrites (broadcast copy assignment): old consumer
    # tid -> {old producer tid: new tid}
    overrides: Dict[int, Dict[int, int]] = {}
    # scatter projections rewritten to direct chunk reads:
    # old projection tid -> (old scatter tid, chunk index, n)
    chunk_rewrites: Dict[int, Tuple[int, int, int]] = {}

    def remap_table(tid: int) -> Dict[int, int]:
        ov = overrides.get(tid)
        return {**old2new, **ov} if ov else old2new

    def remap_refs(obj: Any, table: Dict[int, int]) -> Any:
        from .tracing import _remap_arg_refs
        return _remap_arg_refs(obj, table)

    def emit_plain(node) -> int:
        table = remap_table(node.tid)
        return new.add_node(
            node.name, node.fn,
            remap_refs(node.args, table), remap_refs(node.kwargs, table),
            node.kind,
            deps=tuple(dict.fromkeys(table[d] for d in node.deps)),
            token_deps=tuple(dict.fromkeys(table[d]
                                           for d in node.token_deps)),
            cost=node.cost, out_bytes=node.out_bytes, meta=node.meta)

    def stage_meta(op: str, root_old: int, level: int, index: int) -> dict:
        return {"collective_stage": {"op": op, "root": root_old,
                                     "level": level, "index": index}}

    def emit_tree(node, info) -> int:
        """all_reduce / gather: chunk-per-level stage tree, root last."""
        op = info["op"]
        if (isinstance(mode, int)
                and (op != "all_reduce" or reshape_reductions)):
            arity = mode
        else:
            arity = info["arity"]   # reduce bracketing == the traced value
        arity = max(2, arity)
        table = remap_table(node.tid)
        # arg order (not the deduped ``deps``) defines leaf order — a ref
        # passed twice participates twice, exactly as the dense fn sees it
        leaves = [table[r.tid] for r in node.args]
        n = len(leaves)
        combine = node.fn.combine if op == "all_reduce" else None
        vals = leaves
        level = 0
        while len(vals) > arity:
            nxt: List[int] = []
            for gi in range(0, len(vals), arity):
                group = vals[gi:gi + arity]
                if len(group) == 1 and not (op == "gather" and level == 0):
                    nxt.append(group[0])    # fold of one == the value
                    continue
                if op == "all_reduce":
                    fn: Callable = _ReduceStage(combine)
                    sbytes = node.out_bytes
                else:
                    fn = _gather_leaf if level == 0 else _gather_concat
                    sbytes = node.out_bytes * len(group) // max(1, n)
                stid = new.add_node(
                    f"{node.name}@L{level}.{gi // arity}", fn,
                    tuple(RemappedRef(v) for v in group), {},
                    TaskKind.COLLECTIVE,
                    deps=tuple(dict.fromkeys(group)),
                    cost=_stage_cost(node.cost, len(group), n),
                    out_bytes=sbytes,
                    meta=stage_meta(op, node.tid, level, gi // arity))
                nxt.append(stid)
            vals = nxt
            level += 1
        if op == "all_reduce":
            root_fn: Callable = _ReduceStage(combine)
        else:
            root_fn = _gather_leaf if level == 0 else _gather_concat
        return new.add_node(
            node.name, root_fn, tuple(RemappedRef(v) for v in vals), {},
            TaskKind.COLLECTIVE, deps=tuple(dict.fromkeys(vals)),
            cost=_stage_cost(node.cost, len(vals), n),
            out_bytes=node.out_bytes, meta=node.meta)

    def emit_broadcast(node, info) -> int:
        arity = mode if isinstance(mode, int) else info["arity"]
        arity = max(2, arity)
        table = remap_table(node.tid)
        root = new.add_node(
            node.name, _identity, remap_refs(node.args, table), {},
            TaskKind.COLLECTIVE,
            deps=tuple(dict.fromkeys(table[d] for d in node.deps)),
            cost=node.cost, out_bytes=node.out_bytes, meta=node.meta)
        consumers = sorted(succ[node.tid])
        if len(consumers) <= arity:
            return root      # the root alone can serve them
        # copy-tree sizes, top-down: the bottom level serves <= arity
        # consumers per copy, each level above serves <= arity copies
        sizes = [math.ceil(len(consumers) / arity)]
        while sizes[0] > arity:
            sizes.insert(0, math.ceil(sizes[0] / arity))
        parents = [root]
        for lvl, size in enumerate(sizes):
            cur: List[int] = []
            for i in range(size):
                p = parents[i // arity]
                cid = new.add_node(
                    f"{node.name}@B{lvl}.{i}", _identity,
                    (RemappedRef(p),), {}, TaskKind.COLLECTIVE,
                    deps=(p,), cost=_stage_cost(node.cost or 1.0, 1,
                                                len(consumers)),
                    out_bytes=node.out_bytes,
                    meta=stage_meta("broadcast", node.tid, lvl, i))
                cur.append(cid)
            parents = cur
        for ci, c in enumerate(consumers):
            overrides.setdefault(c, {})[node.tid] = parents[ci // arity]
        return root

    def emit_scatter(node, info) -> int:
        table = remap_table(node.tid)
        root = new.add_node(
            node.name, node.fn, remap_refs(node.args, table), {},
            TaskKind.COLLECTIVE,
            deps=tuple(dict.fromkeys(table[d] for d in node.deps)),
            cost=node.cost, out_bytes=node.out_bytes, meta=node.meta)
        n = info["n"]
        for c in succ[node.tid]:
            cn = graph.nodes[c]
            if (cn.kind is TaskKind.PROJECTION
                    and isinstance(cn.fn, _Project)
                    and cn.deps == (node.tid,) and 0 <= cn.fn.idx < n):
                chunk_rewrites[c] = (node.tid, cn.fn.idx, n)
        return root

    for tid in sorted(graph.nodes):     # ascending tid IS topo order
        node = graph.nodes[tid]
        if tid in chunk_rewrites:
            src_old, idx, n = chunk_rewrites[tid]
            # read the chunk straight off the scatter *source*, not the
            # dense tuple — the only bytes that move are the chunk's
            src_new = old2new[graph.nodes[src_old].deps[0]]
            old2new[tid] = new.add_node(
                f"{node.name}[{idx}/{n}]", _ScatterChunk(idx, n),
                (RemappedRef(src_new),), {}, TaskKind.COLLECTIVE,
                deps=(src_new,), cost=node.cost,
                out_bytes=graph.nodes[src_old].out_bytes // max(1, n),
                meta=stage_meta("scatter", src_old, 0, idx))
            continue
        info = node.meta.get("collective") \
            if node.kind is TaskKind.COLLECTIVE else None
        if info is None:
            old2new[tid] = emit_plain(node)
        elif info["op"] in ("all_reduce", "gather"):
            old2new[tid] = emit_tree(node, info)
        elif info["op"] == "broadcast":
            old2new[tid] = emit_broadcast(node, info)
        elif info["op"] == "scatter":
            old2new[tid] = emit_scatter(node, info)
        else:
            raise GraphError(f"unknown collective op {info['op']!r} "
                             f"on task {node.name}#{tid}")

    for o in graph.outputs:
        new.mark_output(old2new[o])
    new.validate()
    new.meta_old2new = old2new  # type: ignore[attr-defined]
    return new, old2new


def collective_stages(graph: TaskGraph, root_old: int) -> List[int]:
    """The lowered stage tids belonging to collective root ``root_old``
    (by original tid) — the bounded set a mid-tree aggregator loss may
    force :func:`repro_torch.core.lineage.recovery_plan_clusters` to replay."""
    return [t for t, n in graph.nodes.items()
            if n.meta.get("collective_stage", {}).get("root") == root_old]

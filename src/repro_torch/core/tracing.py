"""Driver tracing — the replacement for the paper's shallow source parser.

Port of ``repro/core/tracing.py``, unchanged apart from this note: tracing
runs the driver in Python and never looks inside a tensor.

The paper parses the user's ``main`` to recover the call-level dependency
graph.  We instead *run* the driver once with future-like :class:`TaskRef`
placeholders: every ``@task``-decorated call appends a DAG node and returns a
ref; plain Python glue (tuple packing, control flow on literals) runs
normally.  This is strictly more robust than shallow parsing — the paper's
own "future work" — while preserving its interface: the user marks the
driver, nothing else.

Effect ordering is the paper's RealWorld rule: each ``@io_task`` call depends
on the previous effectful call through a token edge.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .graph import TaskGraph, TaskKind
from . import purity

_STATE = threading.local()


def _current_trace() -> Optional["Trace"]:
    return getattr(_STATE, "trace", None)


class TaskRef:
    """Future-like placeholder for the value produced by a task."""

    __slots__ = ("trace", "tid", "length")

    def __init__(self, trace: "Trace", tid: int, length: Optional[int] = None):
        self.trace = trace
        self.tid = tid
        self.length = length  # known tuple-length of the output, if declared

    def __getitem__(self, idx: int) -> "TaskRef":
        if not isinstance(idx, int):
            raise TypeError("TaskRef only supports integer projection")
        return self.trace.add_projection(self, idx)

    def __iter__(self):
        if self.length is None:
            raise TypeError(
                "cannot unpack a TaskRef of unknown arity; declare "
                "@task(n_outputs=k) to enable `a, b = f(...)`")
        return (self[i] for i in range(self.length))

    def __repr__(self) -> str:
        return f"TaskRef<{self.trace.graph.nodes[self.tid].name}#{self.tid}>"

    # Refs must never silently leak into numeric Python — fail loudly.
    def __bool__(self):
        raise TypeError("TaskRef cannot be used in Python control flow; "
                        "branch on literals or move the branch inside a task")


def _find_refs(obj: Any, acc: List[TaskRef]) -> None:
    if isinstance(obj, TaskRef):
        acc.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _find_refs(o, acc)
    elif isinstance(obj, dict):
        for o in obj.values():
            _find_refs(o, acc)


class _Project:
    """Tuple-element projection node body.  A class (not a lambda) so traced
    graphs stay picklable for spawn-based cluster workers."""

    __slots__ = ("idx",)

    def __init__(self, idx: int):
        self.idx = idx

    def __call__(self, t):
        return t[self.idx]


def _barrier_fn(*xs):
    """Barrier node body: identity on one value, tuple otherwise (picklable
    module-level function — see :class:`_Project`)."""
    return xs if len(xs) != 1 else xs[0]


class Trace:
    """Active tracing context; builds a :class:`TaskGraph`."""

    def __init__(self) -> None:
        self.graph = TaskGraph()
        self._last_token_tid: Optional[int] = None

    # -- context manager ----------------------------------------------------
    def __enter__(self) -> "Trace":
        if _current_trace() is not None:
            raise RuntimeError("traces do not nest; one driver at a time")
        _STATE.trace = self
        return self

    def __exit__(self, *exc) -> None:
        _STATE.trace = None

    # -- node creation ------------------------------------------------------
    def add_call(self, fn: Callable, name: str, args: Tuple, kwargs: Dict,
                 pure: bool, cost: float, out_bytes: int,
                 n_outputs: Optional[int], meta: Optional[dict] = None) -> TaskRef:
        refs: List[TaskRef] = []
        _find_refs(args, refs)
        _find_refs(kwargs, refs)
        for r in refs:
            if r.trace is not self:
                raise RuntimeError("TaskRef from a different trace")
        deps = tuple(dict.fromkeys(r.tid for r in refs))
        token_deps: Tuple[int, ...] = ()
        kind = TaskKind.PURE
        if not pure:
            kind = TaskKind.EFFECTFUL
            if self._last_token_tid is not None:
                token_deps = (self._last_token_tid,)
        tid = self.graph.add_node(
            name=name, fn=fn, args=args, kwargs=kwargs, kind=kind,
            deps=deps, token_deps=token_deps, cost=cost, out_bytes=out_bytes,
            meta=meta,
        )
        if not pure:
            self._last_token_tid = tid
        return TaskRef(self, tid, length=n_outputs)

    def add_projection(self, ref: TaskRef, idx: int) -> TaskRef:
        tid = self.graph.add_node(
            name=f"π{idx}", fn=_Project(idx),
            args=(ref,), kwargs={}, kind=TaskKind.PROJECTION,
            deps=(ref.tid,), token_deps=(), cost=0.0, out_bytes=0,
        )
        return TaskRef(self, tid)

    def add_barrier(self, refs: Sequence[TaskRef], name: str = "checkpoint") -> TaskRef:
        """Materialization barrier — lineage recovery never recomputes past it."""
        deps = tuple(dict.fromkeys(r.tid for r in refs))
        tid = self.graph.add_node(
            name=name, fn=_barrier_fn,
            args=tuple(refs), kwargs={}, kind=TaskKind.BARRIER,
            deps=deps, token_deps=(), cost=0.0, out_bytes=0,
        )
        return TaskRef(self, tid)


# --------------------------------------------------------------------------
# decorators
# --------------------------------------------------------------------------

def task(fn: Optional[Callable] = None, *, cost: Any = 1.0, out_bytes: Any = 0,
         name: Optional[str] = None, n_outputs: Optional[int] = None,
         pure: bool = True, meta: Optional[dict] = None):
    """Mark ``fn`` as a schedulable unit.

    ``cost``/``out_bytes`` may be literals or callables of the call's
    (literal) arguments — used by the scheduler's cost model and the
    work-stealing policy.  Outside a trace the function runs eagerly, so
    decorated code keeps working as ordinary Python.
    """
    def wrap(f: Callable):
        purity.declare(f, pure)

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            tr = _current_trace()
            if tr is None:
                return f(*args, **kwargs)
            c = cost(*args, **kwargs) if callable(cost) else float(cost)
            b = out_bytes(*args, **kwargs) if callable(out_bytes) else int(out_bytes)
            return tr.add_call(f, name or f.__name__, args, kwargs,
                               pure=pure, cost=c, out_bytes=b,
                               n_outputs=n_outputs, meta=meta)

        wrapper.__wrapped_task__ = f
        wrapper.__task_pure__ = pure
        return wrapper

    return wrap(fn) if fn is not None else wrap


def io_task(fn: Optional[Callable] = None, **kw):
    """``IO``-typed task: ordered through the RealWorld token chain."""
    kw["pure"] = False
    return task(fn, **kw) if fn is not None else task(**kw)


def checkpoint_barrier(*refs: TaskRef, name: str = "checkpoint") -> TaskRef:
    tr = _current_trace()
    if tr is None:
        raise RuntimeError("checkpoint_barrier only makes sense inside trace()")
    return tr.add_barrier(refs, name=name)


def placeholder(name: str, *, out_bytes: int = 0) -> TaskRef:
    """Graph input: a zero-cost source node resolved from the executor's
    ``inputs`` dict at run time (the driver's arguments, in paper terms)."""
    tr = _current_trace()
    if tr is None:
        raise RuntimeError("placeholder only makes sense inside trace()")
    return tr.add_call(
        fn=None, name=f"input:{name}", args=(), kwargs={}, pure=True,
        cost=0.0, out_bytes=out_bytes, n_outputs=None, meta={"input": name})


# --------------------------------------------------------------------------
# collective primitives (repro_torch.core.collectives holds the machinery; the
# imports are lazy because collectives.py imports helpers from this module)
# --------------------------------------------------------------------------

def _collective_trace() -> "Trace":
    tr = _current_trace()
    if tr is None:
        raise RuntimeError("collectives only make sense inside trace(); "
                           "outside a trace there is no graph to shape")
    return tr


def all_reduce(refs: Sequence[TaskRef], op="sum", *, arity: int = None,
               cost: float = 1.0, out_bytes: int = 0,
               name: str = None) -> TaskRef:
    """Reduce ``refs`` to one value with ``op`` (``"sum"``/``"max"``/
    ``"min"``/``"concat"`` or a picklable binary callable) along a
    deterministic combine tree.  The tree's bracketing is part of the
    value (float combines are not associative), so every backend —
    sequential oracle included — computes the identical bits.  Lowered to
    staged tree hops by :func:`repro_torch.core.collectives.lower_collectives`."""
    from .collectives import DEFAULT_ARITY, add_all_reduce
    tr = _collective_trace()
    tid = add_all_reduce(tr.graph, [r.tid for r in refs], op,
                         arity=arity or DEFAULT_ARITY, name=name,
                         cost=cost, out_bytes=out_bytes)
    return TaskRef(tr, tid)


def gather(refs: Sequence[TaskRef], *, arity: int = None, cost: float = 1.0,
           out_bytes: int = 0, name: str = None) -> TaskRef:
    """Collect ``refs`` into one tuple (in order) via a concatenation
    tree — the many-to-one shape a wide fan-in consumer pays N
    point-to-point edges for today.  Unpackable: ``a, b, c = gather(...)``."""
    from .collectives import DEFAULT_ARITY, add_gather
    tr = _collective_trace()
    tid = add_gather(tr.graph, [r.tid for r in refs],
                     arity=arity or DEFAULT_ARITY, name=name,
                     cost=cost, out_bytes=out_bytes)
    return TaskRef(tr, tid, length=len(refs))


def broadcast(ref: TaskRef, *, arity: int = None, cost: float = 0.0,
              out_bytes: int = 0, name: str = None) -> TaskRef:
    """One-to-many replication: consumers of the returned ref are fanned
    out across a copy tree at lowering time (<= ``arity`` readers per
    copy), so no single worker serves every consumer of a hot value."""
    from .collectives import DEFAULT_ARITY, add_broadcast
    tr = _collective_trace()
    tid = add_broadcast(tr.graph, ref.tid, arity=arity or DEFAULT_ARITY,
                        name=name, cost=cost, out_bytes=out_bytes)
    return TaskRef(tr, tid)


def scatter(ref: TaskRef, n: int, *, arity: int = None, cost: float = 0.0,
            out_bytes: int = 0, name: str = None) -> TaskRef:
    """Split ``ref`` into ``n`` contiguous leading-axis chunks:
    ``parts = scatter(x, 4)`` then ``parts[i]`` (or unpack).  Lowering
    rewrites each projection into a direct chunk read off the source, so
    consumers pull their slice, never the whole value."""
    from .collectives import DEFAULT_ARITY, add_scatter
    tr = _collective_trace()
    tid = add_scatter(tr.graph, ref.tid, n, arity=arity or DEFAULT_ARITY,
                      name=name, cost=cost, out_bytes=out_bytes)
    return TaskRef(tr, tid, length=n)


# --------------------------------------------------------------------------
# ref substitution (shared by every executor)
# --------------------------------------------------------------------------

class RemappedRef:
    """A bare task-id reference used after graph transforms re-assign ids."""

    __slots__ = ("tid",)

    def __init__(self, tid: int):
        self.tid = tid

    def __repr__(self):
        return f"RemappedRef<{self.tid}>"


def substitute_refs(obj: Any, table: Dict[int, Any]) -> Any:
    """Replace every (Remapped)TaskRef in ``obj`` with ``table[ref.tid]``."""
    if isinstance(obj, (TaskRef, RemappedRef)):
        return table[obj.tid]
    if isinstance(obj, tuple):
        return tuple(substitute_refs(o, table) for o in obj)
    if isinstance(obj, list):
        return [substitute_refs(o, table) for o in obj]
    if isinstance(obj, dict):
        return {k: substitute_refs(v, table) for k, v in obj.items()}
    return obj


def _remap_arg_refs(obj: Any, old2new: Dict[int, int]) -> Any:
    if isinstance(obj, (TaskRef, RemappedRef)):
        return RemappedRef(old2new[obj.tid])
    if isinstance(obj, tuple):
        return tuple(_remap_arg_refs(o, old2new) for o in obj)
    if isinstance(obj, list):
        return [_remap_arg_refs(o, old2new) for o in obj]
    if isinstance(obj, dict):
        return {k: _remap_arg_refs(v, old2new) for k, v in obj.items()}
    return obj


def offset_graph(graph: TaskGraph, base: int,
                 input_ns: Optional[str] = None) -> TaskGraph:
    """Rebase every task id of ``graph`` by ``+base`` into a fresh graph.

    The gateway's resident executor runs many tenants' graphs inside ONE
    growing union graph; each admitted job gets a private, non-overlapping
    id range ``[base, base + len(graph))`` so that the object store, the
    lineage index and the run log never confuse two tenants' values.
    ``input_ns`` (e.g. ``"j3/"``) prefixes every placeholder name the same
    way, namespacing the ``inputs`` dict per job.

    The offset preserves topo order (a uniform shift keeps ``dep < tid``),
    so the result validates iff the input did.  Nodes are shared, not
    copied, except for ``meta`` when the input name is rewritten.
    """
    old2new = {t: t + base for t in graph.nodes}
    out = TaskGraph()
    for tid in sorted(graph.nodes):
        n = graph.nodes[tid]
        meta = n.meta
        if input_ns and "input" in meta:
            meta = dict(meta)
            meta["input"] = input_ns + meta["input"]
        out.nodes[tid + base] = dataclasses.replace(
            n,
            tid=tid + base,
            args=_remap_arg_refs(n.args, old2new),
            kwargs=_remap_arg_refs(n.kwargs, old2new),
            deps=tuple(d + base for d in n.deps),
            token_deps=tuple(d + base for d in n.token_deps),
            meta=meta,
        )
    out.outputs = [o + base for o in graph.outputs]
    out._next_id = base + (max(graph.nodes) + 1 if graph.nodes else 0)
    return out


# --------------------------------------------------------------------------
# trace entry point + granularity fusion
# --------------------------------------------------------------------------

def trace(driver: Callable, *args, fuse_below: float = 0.0, **kwargs):
    """Run ``driver`` under tracing; return ``(graph, outputs)``.

    ``outputs`` mirrors the driver's return structure (TaskRefs inside).
    ``fuse_below`` fuses linear chains of pure tasks whose cost is below the
    threshold (the paper's "user-specified granularity" future-work knob).
    """
    with Trace() as tr:
        out = driver(*args, **kwargs)
        refs: List[TaskRef] = []
        _find_refs(out, refs)
        for r in refs:
            tr.graph.mark_output(r.tid)
    graph = tr.graph
    if fuse_below > 0.0:
        graph = fuse_cheap_chains(graph, fuse_below)
    graph.validate()
    return graph, out


def fuse_cheap_chains(graph: TaskGraph, threshold: float) -> TaskGraph:
    """Granularity control: fuse linear chains ``a -> b`` when both are pure
    with cost < threshold, ``a`` has a single consumer and ``b`` a single
    value-dependency.  Returns a NEW graph (ids re-assigned, topo order
    preserved); fusion composes the Python callables so executors need no
    changes.
    """
    succ = graph.successors()
    chains: Dict[int, List[int]] = {}   # chain head -> members (exec order)
    absorbed: Dict[int, int] = {}       # member tid -> chain head

    for tid in graph.topo_order():
        node = graph.nodes[tid]
        if (node.kind is TaskKind.PURE and node.cost < threshold
                and len(node.deps) == 1 and not node.token_deps):
            head = absorbed.get(node.deps[0], node.deps[0])
            hnode = graph.nodes[head]
            if (hnode.kind is TaskKind.PURE and hnode.cost < threshold
                    and len(succ[node.deps[0]]) == 1
                    and node.deps[0] not in graph.outputs):
                chains.setdefault(head, [head]).append(tid)
                absorbed[tid] = head

    new = TaskGraph()
    old2new: Dict[int, int] = {}
    for tid in graph.topo_order():
        if tid in absorbed:
            continue   # id assigned when its chain head is emitted
        members = chains.get(tid, [tid])
        nodes = [graph.nodes[m] for m in members]
        head = nodes[0]
        if len(nodes) == 1:
            ntid = new.add_node(
                head.name, head.fn,
                _remap_arg_refs(head.args, old2new),
                _remap_arg_refs(head.kwargs, old2new),
                head.kind,
                deps=tuple(old2new[d] for d in head.deps),
                token_deps=tuple(old2new[d] for d in head.token_deps),
                cost=head.cost, out_bytes=head.out_bytes, meta=head.meta)
        else:
            tail = tuple(nodes[1:])

            def fused(*args, _head=head, _tail=tail, **kwargs):
                val = _head.fn(*args, **kwargs)
                for nd in _tail:
                    # each tail member's only refs point at its predecessor
                    tbl = {nd.deps[0]: val}
                    val = nd.fn(*substitute_refs(nd.args, tbl),
                                **substitute_refs(nd.kwargs, tbl))
                return val

            ntid = new.add_node(
                "+".join(n.name for n in nodes), fused,
                _remap_arg_refs(head.args, old2new),
                _remap_arg_refs(head.kwargs, old2new),
                TaskKind.PURE,
                deps=tuple(old2new[d] for d in head.deps),
                token_deps=(),
                cost=sum(n.cost for n in nodes),
                out_bytes=nodes[-1].out_bytes, meta=head.meta)
        for m in members:
            old2new[m] = ntid
    for o in graph.outputs:
        new.mark_output(old2new[o])
    new.meta_old2new = old2new  # type: ignore[attr-defined]
    return new

"""Task-graph IR — the data-dependency DAG the paper's parser produces.

Port of ``repro/core/graph.py``, unchanged: the IR is plain Python.

A :class:`TaskGraph` is the runtime's analogue of the dependency graph the
paper extracts from a Haskell ``main``: nodes are coarse-grained function
calls, edges are value dependencies, and effectful nodes additionally carry
*token* dependencies (the paper's "RealWorld is an input and output of each
IO function").
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple


class TaskKind(enum.Enum):
    PURE = "pure"          # freely parallelizable (Haskell: ``a -> b``)
    EFFECTFUL = "io"       # ordered via token edges (Haskell: ``IO b``)
    PROJECTION = "proj"    # zero-cost tuple-element projection
    BARRIER = "barrier"    # checkpoint/materialization barrier (lineage cut)
    COLLECTIVE = "coll"    # group-communication node (broadcast / scatter /
    #                        gather / all_reduce): semantically a pure
    #                        function of its inputs, but carrying a
    #                        communication *shape* in ``meta["collective"]``
    #                        that repro_torch.core.collectives compiles into
    #                        tree-structured staged hops before dispatch


@dataclasses.dataclass
class TaskNode:
    """One node of the dependency DAG.

    ``args``/``kwargs`` may contain :class:`repro_torch.core.tracing.TaskRef`
    placeholders (dependencies) or plain literals.  ``deps`` is the resolved
    list of producer task ids (value deps first, then token deps).
    """

    tid: int
    name: str
    fn: Optional[Callable]
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    kind: TaskKind
    deps: Tuple[int, ...]            # value dependencies (producer tids)
    token_deps: Tuple[int, ...]      # effect-ordering dependencies
    cost: float = 1.0                # abstract cost estimate (seconds-ish)
    out_bytes: int = 0               # estimated output size (placement/steal)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def all_deps(self) -> Tuple[int, ...]:
        return tuple(dict.fromkeys(self.deps + self.token_deps))


class GraphError(ValueError):
    pass


class TaskGraph:
    """Append-only DAG of :class:`TaskNode`."""

    def __init__(self) -> None:
        self.nodes: Dict[int, TaskNode] = {}
        self._next_id = 0
        self.outputs: List[int] = []   # tids whose values the driver returns

    # ------------------------------------------------------------- building
    def add_node(
        self,
        name: str,
        fn: Optional[Callable],
        args: Tuple[Any, ...],
        kwargs: Dict[str, Any],
        kind: TaskKind,
        deps: Sequence[int],
        token_deps: Sequence[int] = (),
        cost: float = 1.0,
        out_bytes: int = 0,
        meta: Optional[Dict[str, Any]] = None,
    ) -> int:
        tid = self._next_id
        self._next_id += 1
        for d in tuple(deps) + tuple(token_deps):
            if d not in self.nodes:
                raise GraphError(f"dependency {d} of task {tid} does not exist")
        self.nodes[tid] = TaskNode(
            tid=tid, name=name, fn=fn, args=args, kwargs=kwargs, kind=kind,
            deps=tuple(deps), token_deps=tuple(token_deps), cost=cost,
            out_bytes=out_bytes, meta=dict(meta or {}),
        )
        return tid

    def mark_output(self, tid: int) -> None:
        if tid not in self.nodes:
            raise GraphError(f"output task {tid} does not exist")
        self.outputs.append(tid)

    # ------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self.nodes)

    def __iter__(self):
        return iter(self.nodes.values())

    def successors(self) -> Dict[int, List[int]]:
        succ: Dict[int, List[int]] = {tid: [] for tid in self.nodes}
        for node in self.nodes.values():
            for d in node.all_deps:
                succ[d].append(node.tid)
        return succ

    def in_degree(self) -> Dict[int, int]:
        return {tid: len(n.all_deps) for tid, n in self.nodes.items()}

    def topo_order(self) -> List[int]:
        """Kahn topological order; raises on cycles (defensive — tracing
        cannot create cycles, but graphs can be built by hand)."""
        indeg = self.in_degree()
        succ = self.successors()
        ready = deque(sorted(t for t, d in indeg.items() if d == 0))
        order: List[int] = []
        while ready:
            t = ready.popleft()
            order.append(t)
            for s in succ[t]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
        if len(order) != len(self.nodes):
            raise GraphError("task graph contains a cycle")
        return order

    def validate(self) -> None:
        self.topo_order()
        for node in self.nodes.values():
            for d in node.all_deps:
                if d >= node.tid:
                    raise GraphError(
                        f"task {node.tid} depends on later/equal task {d}")

    def ancestors(self, tids: Iterable[int]) -> Set[int]:
        seen: Set[int] = set()
        stack = list(tids)
        while stack:
            t = stack.pop()
            if t in seen:
                continue
            seen.add(t)
            stack.extend(self.nodes[t].all_deps)
        return seen

    # -------------------------------------------------------- cost analysis
    def critical_path_rank(self) -> Dict[int, float]:
        """Upward rank: cost of the node + longest downstream cost chain.

        This is the (communication-free) HEFT ``rank_u`` used as scheduling
        priority — the paper's greedy scheduler extended with critical-path
        tie-breaking.
        """
        rank: Dict[int, float] = {}
        succ = self.successors()
        for tid in reversed(self.topo_order()):
            node = self.nodes[tid]
            down = max((rank[s] for s in succ[tid]), default=0.0)
            rank[tid] = node.cost + down
        return rank

    def critical_path_length(self) -> float:
        rank = self.critical_path_rank()
        return max(rank.values(), default=0.0)

    def total_work(self) -> float:
        return sum(n.cost for n in self.nodes.values())

    def max_parallelism(self) -> float:
        """Work / span — the classic upper bound on useful workers."""
        span = self.critical_path_length()
        return self.total_work() / span if span > 0 else 1.0

    # ------------------------------------------------------------ rendering
    def to_dot(self) -> str:
        lines = ["digraph tasks {", "  rankdir=TB;"]
        shapes = {"pure": "ellipse", "io": "box", "proj": "point",
                  "barrier": "octagon", "coll": "doubleoctagon"}
        for node in self.nodes.values():
            shape = shapes.get(node.kind.value, "ellipse")
            label = f"{node.name}#{node.tid}"
            if node.kind is TaskKind.COLLECTIVE:
                # a collective root carries its shape; a lowered stage node
                # carries which root it is a hop of (see core/collectives.py)
                info = node.meta.get("collective")
                stage = node.meta.get("collective_stage")
                if info:
                    label += (f"\\n{info.get('op', '?')}"
                              f"(n={info.get('n', '?')}, "
                              f"arity={info.get('arity', '?')})")
                elif stage:
                    label += (f"\\n{stage.get('op', '?')} stage "
                              f"L{stage.get('level', '?')} "
                              f"of #{stage.get('root', '?')}")
            lines.append(
                f'  t{node.tid} [label="{label}" shape={shape}];')
        for node in self.nodes.values():
            for d in node.deps:
                lines.append(f"  t{d} -> t{node.tid};")
            for d in node.token_deps:
                lines.append(f'  t{d} -> t{node.tid} [style=dashed,label="RW"];')
        lines.append("}")
        return "\n".join(lines)

    def summary(self) -> str:
        kinds: Dict[str, int] = {}
        colls: Dict[str, int] = {}
        for n in self.nodes.values():
            kinds[n.kind.value] = kinds.get(n.kind.value, 0) + 1
            if n.kind is TaskKind.COLLECTIVE and "collective" in n.meta:
                op = n.meta["collective"].get("op", "?")
                colls[op] = colls.get(op, 0) + 1
        coll = f", collectives={colls}" if colls else ""
        return (f"TaskGraph(n={len(self.nodes)}, kinds={kinds}{coll}, "
                f"work={self.total_work():.3g}, span={self.critical_path_length():.3g}, "
                f"max_parallelism={self.max_parallelism():.2f})")

"""SPMD mesh executor: a TaskGraph run on every rank of a device mesh.

Port of ``repro/core/mesh_executor.py`` (:27-121).  The reference lowers
the whole graph into one XLA program over the mesh: each task body inlined
in topological order, every intermediate constrained to the sharding the
placement pass chose, and XLA's SPMD partitioner in the role of per-task
message passing.  Here every rank of the mesh's world runs the graph in
topological order on DTensors: graph inputs (the full value, the same on
every rank) are laid out by ``input_axes``, each value is redistributed to
its refined spec (the reference's ``with_sharding_constraint``), and the
task bodies run on DTensors, whose sharding propagation takes GSPMD's
role.  The port's kernels run on each rank's local shard
(``kernels/sharded.py``).  A value without a spec, or with the replicated
one, is left as its task made it (a plain tensor becomes a replicated
DTensor); values that are not tensors pass as they are.

The paper's semantics hold: pure tasks run in a topological order and
effect-token edges are data dependencies, so effect order is preserved.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor

from .graph import TaskGraph
from .placement import (Rule, Spec, ValueInfo, logical_to_spec,
                        refine_placements, shard)
from .tracing import substitute_refs


class MeshExecutor:
    """Run a TaskGraph on every rank of ``mesh``.

    ``value_info`` (optional) enables the greedy placement refinement
    (``self.specs``); tasks without info keep the layout their body gives.
    Graph inputs (``placeholder`` nodes) are laid out by the rule table's
    spec of their ``input_axes``.  ``donate_inputs`` is accepted only for
    the reference's signature and read by nothing: the executor holds no
    copy of an input past the call, so there is nothing to give up.

    The mesh must be over a world (``parallel.mesh.make_mesh_for`` after
    ``init_world``); every rank of the mesh calls the executor with the
    same inputs.
    """

    def __init__(
        self,
        graph: TaskGraph,
        mesh,
        rules: Sequence[Rule],
        *,
        value_info: Optional[Dict[int, ValueInfo]] = None,
        input_axes: Optional[Dict[str, tuple]] = None,
        donate_inputs: Sequence[str] = (),
    ) -> None:
        graph.validate()
        if mesh.device_mesh is None:
            raise ValueError("MeshExecutor needs a mesh over a world: call "
                             "parallel.mesh.init_world, then make_mesh_for")
        self.graph = graph
        self.mesh = mesh
        self.rules = list(rules)
        self.input_axes = dict(input_axes or {})
        self.specs: Dict[int, Spec] = (
            refine_placements(graph, value_info, self.rules, mesh)
            if value_info else {})
        self._order = graph.topo_order()
        self._inputs = {n.meta["input"]: tid for tid, n in graph.nodes.items()
                        if "input" in n.meta}
        self._counter = None

    def input_spec(self, name: str) -> Spec:
        return logical_to_spec(self.input_axes.get(name, ()), self.rules,
                               self.mesh.axis_names)

    def _place(self, val: Any, spec: Spec) -> Any:
        if not isinstance(val, torch.Tensor):
            return val
        if isinstance(val, DTensor) and spec == ():
            return val
        if val.dim() < len(spec):
            raise ValueError(f"spec {spec} names {len(spec)} dims of a "
                             f"{val.dim()}-d value")
        return shard(val, self.mesh, spec)

    def _run(self, inputs: Dict[str, Any]) -> List[Any]:
        graph, results = self.graph, {}
        for tid in self._order:
            node = graph.nodes[tid]
            if "input" in node.meta:
                name = node.meta["input"]
                val = self._place(inputs[name], self.input_spec(name))
            else:
                val = node.fn(*substitute_refs(node.args, results),
                              **substitute_refs(node.kwargs, results))
            results[tid] = self._place(val, self.specs.get(tid, ()))
        return [results[t] for t in graph.outputs]

    # ------------------------------------------------------------------
    def compile(self, example_inputs: Optional[Dict[str, Any]] = None):
        """Check the graph and the inputs named; nothing runs ahead of time
        (the specs were resolved at construction)."""
        self.graph.validate()
        unknown = set(example_inputs or ()) - set(self._inputs)
        if unknown:
            raise ValueError(f"not inputs of the graph: {sorted(unknown)}")
        return self

    def __call__(self, inputs: Optional[Dict[str, Any]] = None) -> List[Any]:
        """The graph's outputs, each DTensor gathered to its full value (the
        same on every rank).  The first call runs under
        ``launch.costs.Counter``, which counts this rank's FLOPs, bytes,
        collectives and memory for :meth:`cost_analysis`,
        :meth:`memory_analysis` and :meth:`hlo_text`; the final gather is
        not counted."""
        inputs = dict(inputs or {})
        missing = set(self._inputs) - set(inputs)
        if missing:
            raise ValueError(f"missing graph inputs: {sorted(missing)}")
        if self._counter is None:
            from ..launch.costs import Counter
            with Counter(log=True) as counter:
                counter.hold(inputs)
                outs = self._run(inputs)
                counter.outputs(outs)
            self._counter = counter
        else:
            outs = self._run(inputs)
        return [o.full_tensor() if isinstance(o, DTensor) else o
                for o in outs]

    # -- introspection used by the roofline benchmarks -------------------
    def _counted(self):
        if self._counter is None:
            raise RuntimeError("call the executor once first")
        return self._counter

    def cost_analysis(self) -> Dict[str, Any]:
        """This rank's FLOPs (``flops``, ``flops_by_dtype``,
        ``flops_by_op``: its local operations', as XLA's cost analysis of a
        partitioned program gives them per device), bytes
        (``bytes accessed``), collectives (``collectives``: their count;
        ``collectives_by_op``; ``collective_events``, each with its group)
        and memory in the first call (``launch.costs.Counter.cost``)."""
        return self._counted().cost()

    def memory_analysis(self):
        """The first call's memory on this rank, as the reference's
        ``memory_analysis()`` attributes: ``argument_size_in_bytes``,
        ``output_size_in_bytes``, ``temp_size_in_bytes`` and
        ``peak_memory_in_bytes``."""
        import types
        return types.SimpleNamespace(**self._counted().memory())

    def hlo_text(self) -> str:
        """The first call's op log on this rank, the counterpart of the
        partitioned HLO: one line a dispatched operation, a DTensor
        operation's line with its global shapes and placements, a
        collective's with its kind, bytes and group
        (``launch.dryrun.parse_collectives`` reads them)."""
        return self._counted().text()

"""Auto-sharding placement: the intra-op half of the auto-parallelizer.

Port of ``repro/core/placement.py``, as plain data.  Every tensor names its
axes with logical names ("batch", "heads", "d_ff", ...); a rule table maps
each name to mesh axes, first match wins, and a mesh axis is never used
twice in one spec (a conflict resolves to replication).  A spec is a tuple
of mesh-axis names (``None`` for a replicated dimension), the entries of
the reference's ``PartitionSpec``, and compares as that does: by its
entries, ``("data",)`` and ``("data", None)`` being two specs.

For task graphs, :func:`refine_placements` picks each value's spec by
greedy coordinate descent on the estimated resharding bytes along the
graph's edges (:func:`resharding_bytes`), the paper's greedy scheduling
principle applied to layouts; ``core/mesh_executor.py`` applies the specs.

Everything here reads only a mesh's ``axis_names`` and ``shape`` (a mapping
from axis name to size), so it runs on any duck-typed mesh, and gives the
reference's specs and byte counts on the same one.  Where the reference
gives a ``NamedSharding``, the port gives DTensor placements
(:func:`placements`, :func:`sharding_for`, :func:`tree_shardings`), and
:func:`shard` lays a tensor out by a spec (``with_sharding_constraint``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..tree import tree_map

MeshAxes = Union[None, str, Tuple[str, ...]]
Rule = Tuple[str, MeshAxes]
Spec = Tuple[MeshAxes, ...]


def standard_rules(mode: str = "fsdp_tp", *,
                   data_axes: Tuple[str, ...] = ("data",),
                   model_axis: str = "model",
                   pod_axis: Optional[str] = "pod") -> List[Rule]:
    """Built-in rule tables.

    ``mode``:
      * ``dp``       — pure data parallel (params replicated)
      * ``dp_tp``    — DP batch + TP on heads/ffn/vocab/experts
      * ``fsdp_tp``  — dp_tp + params/optimizer sharded over data axes (ZeRO-3)
      * ``dp_tp_ep`` — dp_tp with experts on the data axes
      * ``dp_tp_kvseq`` — serving: the KV cache sharded on its sequence dim
      * ``fsdp_tp_sp``  — fsdp_tp with Megatron-style sequence parallelism
    The ``pod`` axis (when present in the mesh) extends the batch axes.
    """
    batch: Tuple[str, ...] = tuple(data_axes)
    if pod_axis:
        batch = (pod_axis,) + batch
    common: List[Rule] = [
        ("batch", batch),
        ("expert_group", batch),     # MoE token groups follow the batch
        ("seq", None),               # sequence sharding: see "sp" variants
        ("kv_seq", None),
    ]
    tp: List[Rule] = [
        ("vocab", model_axis),
        ("heads", model_axis),
        ("kv_heads", model_axis),
        ("heads_dim", model_axis),   # packed H*head_dim weight axis
        ("kv_dim", model_axis),      # packed KH*head_dim weight axis
        ("d_ff", model_axis),
        ("experts", model_axis),
        ("ssm_inner", model_axis),   # mamba d_inner
        ("ssm_heads", model_axis),
        ("conv_dim", model_axis),
        ("layers", None),
        ("norm_dim", None),
        ("state", None),
    ]
    if mode == "dp":
        return (common + [(r, None) for r, _ in tp]
                + [("embed", None), ("d_model", None)])
    if mode == "dp_tp":
        return common + tp + [("embed", None), ("d_model", None)]
    if mode == "fsdp_tp":
        return common + tp + [("embed", tuple(data_axes)), ("d_model", None)]
    if mode == "dp_tp_ep":
        rules = common + [("experts", tuple(data_axes))] + tp
        return rules + [("embed", None), ("d_model", None)]
    if mode == "dp_tp_kvseq":
        base = standard_rules("dp_tp", data_axes=data_axes,
                              model_axis=model_axis, pod_axis=pod_axis)
        return ([("kv_seq", model_axis), ("kv_heads", None)]
                + [(n, a) for (n, a) in base if n not in
                   ("kv_seq", "kv_heads")])
    if mode == "fsdp_tp_sp":
        base = standard_rules("fsdp_tp", data_axes=data_axes,
                              model_axis=model_axis, pod_axis=pod_axis)
        return sequence_parallel_rules(base, seq_axis=model_axis)
    raise ValueError(f"unknown mode {mode!r}")


def sequence_parallel_rules(base: List[Rule], *,
                            seq_axis: str = "model") -> List[Rule]:
    """Enable sequence sharding (ring-attention-style SP) on top of a table."""
    out = [(n, a) for (n, a) in base if n not in ("seq", "kv_seq")]
    return [("seq", seq_axis), ("kv_seq", seq_axis)] + out


def logical_to_spec(axes: Sequence[Optional[str]], rules: Sequence[Rule],
                    mesh_axes: Optional[Sequence[str]] = None) -> Spec:
    """Map logical axis names to a spec via first-match rules.

    A mesh axis already consumed by an earlier tensor dimension is dropped
    (replication instead of an invalid spec).  ``mesh_axes`` (the mesh's
    axis names, ``mesh.axis_names`` in the reference) drops the mesh axes
    a mesh lacks.  "seq"/"kv_seq" claim mesh axes last, so under sequence
    parallelism they yield the TP axis to heads/d_ff within one tensor.
    """
    rule_map: Dict[str, MeshAxes] = {}
    for name, target in rules:
        rule_map.setdefault(name, target)
    used: set = set()
    parts: List[MeshAxes] = [None] * len(axes)
    order = ([i for i, ax in enumerate(axes) if ax not in ("seq", "kv_seq")]
             + [i for i, ax in enumerate(axes) if ax in ("seq", "kv_seq")])
    for i in order:
        ax = axes[i]
        target = rule_map.get(ax) if ax is not None else None
        if target is None:
            continue
        cand = (target,) if isinstance(target, str) else tuple(target)
        if mesh_axes is not None:
            cand = tuple(a for a in cand if a in mesh_axes)
        cand = tuple(a for a in cand if a not in used)
        used.update(cand)
        if not cand:
            continue
        parts[i] = cand[0] if len(cand) == 1 else cand
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements(spec: Spec, axis_names: Sequence[str]) -> Tuple:
    """The DTensor placements of ``spec`` on a mesh of ``axis_names``: for
    each mesh dimension, ``Shard(d)`` if the spec names it on tensor dim
    ``d``, else ``Replicate()``.  A tensor dim split over several mesh axes
    must name them in the mesh's order (major to minor, as the reference's
    ``P(("pod", "data"))``).  ``torch.distributed.tensor`` is imported
    here, not with the module: the cluster's workers import ``core`` and
    never lay out a DTensor."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        order = [axis_names.index(a) for a in axes if a in axis_names]
        if order != sorted(order):
            raise ValueError(f"spec {spec} splits dim {d} over {axes} out "
                             f"of the mesh's order {tuple(axis_names)}")
        for a in axes:
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in axis_names)


def shard(x: torch.Tensor, mesh, spec: Spec):
    """``x`` as a DTensor laid out by ``spec`` on ``mesh``: a DTensor is
    redistributed; a plain tensor is taken as the full value, the same on
    every rank, and each rank keeps its own slice (no communication)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    want = placements(spec, mesh.axis_names)
    if isinstance(x, DTensor):
        return x.redistribute(mesh.device_mesh, want)
    return distribute_tensor(x, mesh.device_mesh, want, src_data_rank=None)


def fit_spec(shape: Sequence[int], spec: Spec, mesh) -> Spec:
    """``spec`` without the mesh axes whose shard count does not divide
    their dim of ``shape`` (the reference's ``_fit_sharding``,
    ``repro/launch/steps.py:222-241``): every DTensor laid out by a fitted
    spec has even shards.  E.g. whisper's vocab of 51865 cannot shard 16
    ways; the embedding is replicated on that dim instead."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out: List[MeshAxes] = []
    for dim, part in zip(shape, parts):
        if part is None:
            out.append(None)
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        out.append(part if dim % n == 0 else None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_shards(spec: Spec, mesh) -> int:
    """The number of pieces ``spec`` cuts a tensor into on ``mesh``."""
    n = 1
    for part in spec:
        if part is None:
            continue
        for ax in ((part,) if isinstance(part, str) else part):
            n *= mesh.shape[ax]
    return n


def sharding_for(axes: Sequence[Optional[str]], rules: Sequence[Rule], mesh):
    """The DTensor placements of a tensor whose axes are named ``axes``
    (the reference's ``NamedSharding``)."""
    return placements(logical_to_spec(axes, rules, mesh.axis_names),
                      mesh.axis_names)


def tree_specs(logical_tree: Any, rules: Sequence[Rule],
               mesh=None) -> Any:
    """Map a tree of logical-axis tuples to a tree of specs."""
    names = mesh.axis_names if mesh is not None else None
    return tree_map(lambda axes: logical_to_spec(axes, rules, names),
                    logical_tree)


def tree_shardings(logical_tree: Any, rules: Sequence[Rule], mesh) -> Any:
    """Map a tree of logical-axis tuples to a tree of DTensor placements."""
    return tree_map(lambda spec: placements(spec, mesh.axis_names),
                    tree_specs(logical_tree, rules, mesh))


# --------------------------------------------------------------------------
# greedy edge-cost refinement for task graphs
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ValueInfo:
    shape: Tuple[int, ...]
    dtype_bytes: int
    logical_axes: Tuple[Optional[str], ...]


def nbytes(info: ValueInfo) -> int:
    return (math.prod(info.shape) * info.dtype_bytes if info.shape
            else info.dtype_bytes)


def resharding_bytes(info: ValueInfo, src: Spec, dst: Spec, mesh) -> float:
    """Crude but monotone model: 0 if specs equal; otherwise each device
    gathers the union shard it is missing — approximated as
    ``bytes/dst_shards - bytes/(src∩dst shards)`` clipped at 0, plus an
    all-to-all term when both are sharded differently."""
    if tuple(src) == tuple(dst):
        return 0.0
    total = nbytes(info)
    s_src = spec_shards(src, mesh)
    s_dst = spec_shards(dst, mesh)
    if s_src == 1:   # replicated -> anything: free (slice locally)
        return 0.0
    if s_dst == 1:   # sharded -> replicated: all-gather
        return total * (1.0 - 1.0 / s_src)
    return total / min(s_src, s_dst)   # resharding ~ all-to-all volume


def candidate_specs(info: ValueInfo, rules: Sequence[Rule],
                    mesh) -> List[Spec]:
    """The rule table's spec, the replicated one, and each single tensor
    axis sharded on each mesh axis that divides it, without repeats."""
    cands = [logical_to_spec(info.logical_axes, rules, mesh.axis_names), ()]
    for dim, size in enumerate(info.shape):
        for ax in mesh.axis_names:
            if size % mesh.shape[ax] == 0 and size >= mesh.shape[ax]:
                parts: List[MeshAxes] = [None] * len(info.shape)
                parts[dim] = ax
                cands.append(tuple(parts))
    return list(dict.fromkeys(cands))


def refine_placements(graph, value_info: Dict[int, ValueInfo],
                      rules: Sequence[Rule], mesh, *,
                      sweeps: int = 2) -> Dict[int, Spec]:
    """Greedy coordinate-descent over per-task output specs.

    Initialize from the rule table, then for each task (topo order) pick the
    candidate spec minimizing resharding bytes to/from its neighbours.  Two
    sweeps are enough in practice (the cost model is submodular-ish); the
    result is guaranteed no worse than the rule-table initialization.
    ``graph`` is duck-typed: ``nodes`` (each with ``deps``),
    ``successors()`` and ``topo_order()``.
    """
    specs: Dict[int, Spec] = {
        tid: logical_to_spec(value_info[tid].logical_axes, rules,
                             mesh.axis_names)
        if tid in value_info else ()
        for tid in graph.nodes
    }
    succ = graph.successors()

    def edge_cost(tid: int, spec: Spec) -> float:
        c = 0.0
        info = value_info.get(tid)
        if info is None:
            return 0.0
        for s in succ[tid]:
            c += (resharding_bytes(info, spec, specs[s], mesh)
                  if s in value_info else 0.0)
        for d in graph.nodes[tid].deps:
            if d in value_info:
                c += resharding_bytes(value_info[d], specs[d], spec, mesh)
        return c

    for _ in range(sweeps):
        for tid in graph.topo_order():
            if tid not in value_info:
                continue
            specs[tid] = min(candidate_specs(value_info[tid], rules, mesh),
                             key=lambda sp: edge_cost(tid, sp))
    return specs


def total_resharding_bytes(graph, value_info: Dict[int, ValueInfo],
                           specs: Dict[int, Spec], mesh) -> float:
    c = 0.0
    for node in graph.nodes.values():
        for d in node.deps:
            if d in value_info and node.tid in value_info:
                c += resharding_bytes(value_info[d], specs[d],
                                      specs[node.tid], mesh)
    return c

"""Placement rule tables: logical tensor axes to mesh axes.

Port of the rule-table half of ``repro/core/placement.py``
(``standard_rules`` :38, ``sequence_parallel_rules`` :111,
``logical_to_spec`` :121), as plain data.  Every tensor names its axes with
logical names ("batch", "heads", "d_ff", ...); a rule table maps each name
to mesh axes, first match wins, and a mesh axis is never used twice in one
spec (a conflict resolves to replication).  ``logical_to_spec`` returns the
spec as a tuple of mesh-axis names (``None`` for a replicated dimension,
trailing ``None``s dropped), the entries of the reference's
``PartitionSpec``.

The greedy cost refinement (``refine_placements``) and the resharding costs
come with intra-op SPMD (ROADMAP §1 item 8); on one device every spec
places the whole tensor on it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

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

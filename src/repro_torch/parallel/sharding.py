"""Model-facing sharding context, and specs as DTensor placements.

Port of ``repro/parallel/sharding.py`` (:21-52).  A context holds a mesh and
a rule table; ``spec`` resolves a tensor's logical axes through the table.
Where the reference builds a ``NamedSharding`` and applies
``with_sharding_constraint``, the port gives DTensor placements
(``core.placement.placements``: ``Shard(d)`` on each mesh dimension the
spec names on tensor dim ``d``, ``Replicate()`` elsewhere) and
redistributes to them (``core.placement.shard``).  On a mesh of one device
a constraint has nothing to move, so ``ShardingCtx.constrain`` returns its
input there.  The launchers run on one device; tensor parallelism inside
them (sharded parameters, flash on each rank's local heads) is ROADMAP §1
item 8b.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from ..core.placement import (Rule, Spec, logical_to_spec, placements,
                              shard, standard_rules, tree_shardings)
from .mesh import Mesh


@dataclasses.dataclass
class ShardingCtx:
    mesh: Optional[Mesh]
    rules: Sequence[Rule]

    @classmethod
    def make(cls, mesh: Optional[Mesh], mode: str = "fsdp_tp") -> "ShardingCtx":
        pod = "pod" if (mesh is not None and "pod" in mesh.axis_names) else None
        return cls(mesh, standard_rules(mode, pod_axis=pod))

    def spec(self, axes: Tuple[Optional[str], ...]) -> Spec:
        return logical_to_spec(
            axes, self.rules,
            self.mesh.axis_names if self.mesh is not None else None)

    def constrain(self, x: torch.Tensor,
                  axes: Tuple[Optional[str], ...]) -> torch.Tensor:
        """``x`` laid out as ``axes`` resolve (``core.placement.shard``); the
        identity without a mesh or on a mesh of one device."""
        if self.mesh is None or self.mesh.size == 1:
            return x
        return shard(x, self.mesh, self.spec(axes))

    def sharding(self, axes: Tuple[Optional[str], ...]) -> Tuple:
        assert self.mesh is not None
        return placements(self.spec(axes), self.mesh.axis_names)


def act_spec(axes: Tuple[Optional[str], ...],
             ctx: Optional[ShardingCtx]) -> Optional[Spec]:
    return ctx.spec(axes) if ctx and ctx.mesh is not None else None


def param_shardings(logical_tree: Any, ctx: ShardingCtx) -> Any:
    """Tree of DTensor placements for a parameter tree's logical axes."""
    assert ctx.mesh is not None
    return tree_shardings(logical_tree, ctx.rules, ctx.mesh)

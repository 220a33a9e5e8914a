"""Model-facing sharding context, for one device.

Port of ``repro/parallel/sharding.py``: a context holds a mesh and a rule
table, and ``spec`` resolves a tensor's logical axes through the table.  On
one device a constraint has nothing to move, so ``constrain`` returns its
input; with more devices it becomes a placement (ROADMAP §1 item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..core.placement import Rule, Spec, logical_to_spec, standard_rules
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
        return x

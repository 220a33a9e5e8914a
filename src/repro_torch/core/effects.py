"""RealWorld-token threading.

Port of ``repro/core/effects.py``.  The paper: "Notice that RealWorld is
considered an input and output by each IO function."  We realize the same
state-token model with an explicit value: every effectful task consumes the
current :class:`EffectToken` and produces a fresh one, which linearizes
effects in the DAG while pure work floats freely.

:meth:`EffectToken.as_array` gives the token as a 0-d float32 tensor, for
code that threads it through tensor programs.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EffectToken:
    """Opaque ordering token. ``epoch`` is only for debugging/printing."""

    epoch: int = 0

    def next(self) -> "EffectToken":
        return EffectToken(self.epoch + 1)

    def as_array(self) -> torch.Tensor:
        return torch.tensor(float(self.epoch), dtype=torch.float32)


def initial_token() -> EffectToken:
    return EffectToken(0)

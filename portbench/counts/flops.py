"""A training step's model FLOPs, as a frozen copy of the convention the
port's ``launch/roofline.py::model_flops`` uses (6 · N · D), with two
changes: N leaves out the input embedding table, which is a lookup and no
product, and attention adds its score and value products, 12 · d_head
FLOPs per visible (query, key) pair per head per layer (4 forward, 8
backward).  Recomputation is not counted: it is work the step chooses to
redo, not work the model needs.

A family's module (``reference/<family>.py``) states what differs: its
``attention_layers(cfg)``, the layers that attend (none where it has no
such function), and its ``active_params(cfg)``, where a token meets fewer
parameters than the tree holds (sparse experts)."""
from __future__ import annotations

from typing import Dict

from ..reference import family
from ..tree import leaves


def params_without_embedding(cfg: Dict) -> int:
    return sum(leaf.numel for leaf in leaves(cfg) if leaf.path != "embed/tok")


def visible_pairs(seq: int, causal: bool = True) -> int:
    """(query, key) pairs a head attends over in one sequence."""
    return seq * (seq + 1) // 2 if causal else seq * seq


def step_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step of ``batch`` sequences of ``seq``
    tokens."""
    module = family(cfg)
    active = getattr(module, "active_params", params_without_embedding)
    attending = getattr(module, "attention_layers", lambda cfg: 0)(cfg)
    return (6.0 * active(cfg) * batch * seq
            + 12.0 * cfg.get("head_dim", 0) * visible_pairs(seq) * batch
            * cfg.get("n_heads", 0) * attending)

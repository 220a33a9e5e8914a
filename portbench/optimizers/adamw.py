"""The port's AdamW after its first step: m = (1 − b1) g, with g the
gradient after the clip."""
from __future__ import annotations

from typing import Dict


def first_grad(state: Dict, opt) -> Dict:
    """The tree of the first gradient, as AdamW's m holds it."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return tree / (1.0 - opt.b1)
    return walk(state["m"])

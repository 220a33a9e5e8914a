"""The parameter tree of a configuration as the benchmark draws it: each
leaf's path, shape and initialiser, from the configuration file's sizes.

It is the tree the port's decoder-only LM takes (stacked layers, the
reference's keys), written down by each family's reference module
(``reference/<family>.py``) so that the benchmark, and not the program,
decides the weights; ``traffic/train.py`` checks it against the program's
own tree before it draws.  The initialisers are the JAX package's
``Builder.p`` distributions: normal with ``fan_in ** -0.5`` unless a scale
is given, zeros, ones, ``mamba_A`` (log of 1..N) and ``mamba_dt`` (the
inverse softplus of a log-uniform dt in [1e-3, 1e-1]).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple


class Leaf(NamedTuple):
    path: str                      # "layers/mixer/wq"
    shape: Tuple[int, ...]
    init: str                      # normal | zeros | ones | mamba_A | mamba_dt
    scale: Optional[float] = None  # normal: None is fan_in ** -0.5

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    def std(self) -> float:
        if self.scale is not None:
            return self.scale
        return (self.shape[-2] if len(self.shape) >= 2
                else self.shape[-1]) ** -0.5


def leaves(cfg: Dict) -> List[Leaf]:
    """The leaves of ``cfg`` (a configuration file's dict), in a fixed
    order: those of its ``family``, found by name as the ``leaves`` of
    ``reference/<family>.py``."""
    from .reference import family
    return family(cfg).leaves(cfg)


def lm_leaves(cfg: Dict) -> List[Leaf]:
    """The leaves every decoder-only family begins with: the token
    embedding, the untied unembedding, the final norm and each layer's
    first norm."""
    d, L, V = cfg["d_model"], cfg["n_layers"], cfg["vocab_size"]
    return [Leaf("embed/tok", (V, d), "normal", 1.0),
            Leaf("embed/unembed", (d, V), "normal"),
            Leaf("final_norm/scale", (d,), "ones"),
            Leaf("layers/norm1/scale", (L, d), "ones")]


def nest(flat: Dict[str, object]) -> Dict:
    """``{"a/b": x}`` as ``{"a": {"b": x}}``."""
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = value
    return tree


def flatten(tree: Dict, prefix: str = "") -> Dict[str, object]:
    """The inverse of :func:`nest`, in sorted key order."""
    out: Dict[str, object] = {}
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten(value, path + "/"))
        else:
            out[path] = value
    return out

"""Trees of nested dicts: the port's counterpart of the ``jax.tree``
functions the reference calls.

A tree is a dict whose values are trees or leaves; anything that is not a
dict is a leaf (a tensor, an array, a number).  Keys are visited in sorted
order, as ``jax.tree_util`` visits a dict's keys, so leaf order and leaf
paths are the reference's: a checkpoint's manifest lists the same leaves in
the same order from either package.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, List, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied at each leaf of ``tree``, with the nodes at the same
    place in ``rest`` as further arguments; the result has ``tree``'s
    structure.  A node of ``rest`` where ``tree`` has a leaf is passed whole,
    as ``jax.tree.map`` passes it after ``flatten_up_to`` (Adafactor's
    ``{"vr", "vc"}`` dict beside a parameter)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_flatten_with_paths(tree: Any, prefix: Tuple[str, ...] = ()
                            ) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in leaf order; a path joins the keys from the
    root with ``"/"``, as ``repro/checkpoint/store.py`` names its leaves."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out.extend(tree_flatten_with_paths(tree[k], prefix + (str(k),)))
        return out
    return [("/".join(prefix), tree)]


_END = object()


def tree_unflatten(like: Any, leaves: Iterable[Any]) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in leaf order."""
    it: Iterator[Any] = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has places for")
    return out


def unstack_layers(tree: Dict, n: int) -> List[Dict]:
    """The ``n`` per-layer trees of a tree of stacked (leading ``n``)
    leaves, each leaf a view.  ``unbind`` gives one gradient node for all
    layers (a stack), where indexing each layer would give each its own
    full-size zero tensor to scatter into."""
    per_leaf = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda parts: parts[i], per_leaf) for i in range(n)]

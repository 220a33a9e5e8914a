"""Model-facing sharding context, and specs as DTensor placements.

Port of ``repro/parallel/sharding.py`` (:21-52).  A context holds a mesh and
a rule table; ``spec`` resolves a tensor's logical axes through the table.
Where the reference builds a ``NamedSharding`` and applies
``with_sharding_constraint``, the port gives DTensor placements
(``core.placement.placements``: ``Shard(d)`` on each mesh dimension the
spec names on tensor dim ``d``, ``Replicate()`` elsewhere) and
redistributes to them (``core.placement.shard``).  Each spec is first
fitted to the tensor's shape (``ShardingCtx.fit``, ``core.placement
.fit_spec``) where the models lay out their values: a mesh axis whose size
does not divide its dim is dropped, so every DTensor of the launchers'
world path has even shards, where GSPMD would pad (a reduced model's 2 kv
heads on a model axis of 4; one served request on a data axis of 2).

The launchers' world path (``launch/train.py``, ``launch/serve.py`` in a
``torch.distributed`` world) runs the models on DTensors: the parameters
laid out by :func:`distribute_params`, the batch by the rule table, and
the model modules constrain their activations at the reference's block
boundaries (``models.layers.shard_act``: ``ShardingCtx.fit``).  Between
them DTensor's sharding propagation places every operator.  Where an
operator has no sharding strategy, or where a layout must be known
exactly (the kernels, the routing, the SSD, the loss), :func:`local_call`
(and :func:`batch_call` over it) runs plain torch code on each
rank's local tensors and wraps the results back, with the gradient
placements given explicitly (``Partial`` where a rank's gradient is a
share of a sum over a sharded dim).  Plain tensors that meet DTensors (a
position ``arange``, a mask, a zero) become replicated DTensors through
:func:`replicated_like`; no call site relies on
``implicit_replication``.

``torch.distributed.tensor`` is imported inside the functions that make or
take DTensors, never with this module: a process that runs no mesh (a
cluster worker, the one-device launchers) never loads it.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..core.placement import (Rule, Spec, fit_spec, logical_to_spec,
                              placements, shard, standard_rules,
                              tree_shardings)
from ..tree import tree_map
from .mesh import Mesh


def is_dtensor(t: Any) -> bool:
    """Whether ``t`` is a DTensor.  No DTensor exists before
    ``torch.distributed.tensor`` is imported, so this imports nothing."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A layout, the reference's ``NamedSharding``: DTensor ``placements``
    on ``device_mesh`` (a ``torch.distributed`` ``DeviceMesh``).  A DTensor
    has the same two attributes, so either serves where a layout is
    read (``checkpoint.store.restore_checkpoint``)."""
    device_mesh: Any
    placements: Tuple


@dataclasses.dataclass
class ShardingCtx:
    mesh: Optional[Mesh]
    rules: Sequence[Rule]

    @classmethod
    def make(cls, mesh: Optional[Mesh], mode: str = "fsdp_tp") -> "ShardingCtx":
        pod = "pod" if (mesh is not None and "pod" in mesh.axis_names) else None
        return cls(mesh, standard_rules(mode, pod_axis=pod))

    @property
    def distributed(self) -> bool:
        """Whether the context's mesh lies over a ``torch.distributed``
        world (values on it are DTensors), also a world of one."""
        return self.mesh is not None and self.mesh.device_mesh is not None

    def spec(self, axes: Tuple[Optional[str], ...]) -> Spec:
        return logical_to_spec(
            axes, self.rules,
            self.mesh.axis_names if self.mesh is not None else None)

    def fitted(self, shape: Sequence[int],
               axes: Tuple[Optional[str], ...]) -> Spec:
        """The spec of ``axes`` fitted to ``shape`` (:meth:`fit_spec`)."""
        return self.fit_spec(shape, self.spec(axes))

    def fit_spec(self, shape: Sequence[int], spec: Spec) -> Spec:
        """``spec`` fitted to ``shape`` (``core.placement.fit_spec``), also
        without the mesh axes of size 1: they shard nothing, and DTensor
        refuses to view away a singleton dim that is sharded, even over
        one rank."""
        ones = {a for a, n in self.mesh.shape.items() if n == 1}

        def keep(part):
            kept = tuple(a for a in ((part,) if isinstance(part, str)
                                     else part or ()) if a not in ones)
            return kept[0] if len(kept) == 1 else kept or None
        return fit_spec(tuple(shape), tuple(map(keep, spec)), self.mesh)

    def constrain(self, x: torch.Tensor,
                  axes: Tuple[Optional[str], ...]) -> torch.Tensor:
        """``x`` laid out as ``axes`` resolve (``core.placement.shard``): a
        DTensor is redistributed, on a mesh of any size; a plain tensor on
        a mesh of more than one rank is taken as the full value and each
        rank keeps its slice (an uneven one where the mesh axis does not
        divide the dim).  The identity for a plain tensor without a mesh,
        on a mesh without a world or on a mesh of one device."""
        if self.mesh is None or not (is_dtensor(x) or (
                self.distributed and self.mesh.size > 1)):
            return x
        return shard(x, self.mesh, self.spec(axes))

    def fit(self, x: torch.Tensor,
            axes: Tuple[Optional[str], ...]) -> torch.Tensor:
        """:meth:`constrain` by the spec :meth:`fitted` to ``x``'s shape,
        making a DTensor of a plain tensor on a world's mesh of any size
        (also of one rank: the world path is one code path whatever the
        world's size): even shards only.  What the model code's constraints
        (``models.layers.shard_act``), the batch and the parameters are
        laid out by."""
        if self.mesh is None or not (is_dtensor(x) or self.distributed):
            return x
        return shard(x, self.mesh, self.fitted(x.shape, axes))

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


def distribute_params(params: Any, logical_axes: Any,
                      ctx: ShardingCtx) -> Any:
    """Each leaf of ``params`` (the full values, the same on every rank) as
    a DTensor laid out by its logical axes (:func:`param_shardings`'s
    placements, fitted to the leaf's shape) through
    ``core.placement.shard``: each rank keeps its slice, no communication.
    The counterpart of placing a tree by its ``NamedSharding``s."""
    assert ctx.distributed, "distribute_params needs a mesh over a world"
    return tree_map(ctx.fit, params, logical_axes)


def layouts(tree: Any) -> Any:
    """The :class:`Sharding` of each DTensor leaf of ``tree`` (``None`` at
    a plain leaf, such as an optimizer's step count)."""
    return tree_map(lambda t: Sharding(t.device_mesh, tuple(t.placements))
                    if is_dtensor(t) else None, tree)


def full_value(t: Any) -> Any:
    """The full value of a DTensor (a collective: every rank calls it);
    anything else as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def replicated_like(t: torch.Tensor, ref: Any) -> torch.Tensor:
    """``t`` (the same full value on every rank) as a replicated DTensor on
    ``ref``'s mesh when ``ref`` is a DTensor and ``t`` is not; else ``t``.
    What a plain tensor made inside the model (positions, masks, zeros)
    must be before it meets a DTensor."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def batch_dims(x: Any) -> Tuple[int, ...]:
    """The mesh dimensions on which DTensor ``x`` is sharded on its dim 0
    (the batch): those a rank's batch rows are split over."""
    from torch.distributed.tensor import Shard
    return tuple(i for i, p in enumerate(x.placements) if p == Shard(0))


def local_call(fn: Callable, args: Sequence[Any],
               arg_placements: Sequence[Optional[Sequence]],
               out_placements: Sequence[Sequence],
               grad_placements: Optional[Sequence] = None,
               shapes: Optional[Sequence] = None) -> Tuple:
    """``fn`` on each rank's local tensors, its results wrapped back as
    DTensors.

    Each tensor arg is taken as a DTensor (a plain one as the replicated
    full value), redistributed to ``arg_placements[i]`` and taken local
    with its gradient laid out as ``grad_placements[i]`` (by default its
    placements; ``Partial`` where the rank's gradient is a share of a sum
    over a dim sharded elsewhere).  An arg whose placements are ``None``
    passes through as it is.  ``fn`` returns a tuple of plain tensors,
    each wrapped with ``out_placements[j]`` as a contiguous tensor of the
    global shape ``shapes[j]`` (by default the local shape times the
    shards: even shards).  Gradients pass through ``to_local`` and
    ``from_local``."""
    from torch.distributed.tensor import DTensor
    ref = next(a for a in args if is_dtensor(a))
    mesh = ref.device_mesh
    grads = grad_placements or [None] * len(args)
    loc = []
    for a, want, grad in zip(args, arg_placements, grads):
        if want is None or not isinstance(a, torch.Tensor):
            loc.append(a)
            continue
        a = replicated_like(a, ref).redistribute(mesh, want)
        loc.append(a.to_local(grad_placements=grad or want))
    outs = fn(*loc)
    wrapped = []
    for j, (o, want) in enumerate(zip(outs, out_placements)):
        kw = {}
        if shapes is not None:
            kw = {"shape": torch.Size(shapes[j]),
                  "stride": torch.empty(shapes[j], device="meta").stride()}
        wrapped.append(DTensor.from_local(o, mesh, want, run_check=False,
                                          **kw))
    return tuple(wrapped)


def batch_call(fn: Callable, like: Any, args: Sequence[Any],
               batch: Sequence[Optional[int]],
               out_batch: Sequence[Any]) -> Tuple:
    """:func:`local_call` on each rank's batch rows, every other dim
    replicated.

    ``like`` is the DTensor whose batch split (:func:`batch_dims`) the call
    keeps (``None``: every arg fully replicated).  ``batch[i]`` is the
    batch dim of ``args[i]``, ``None`` for an arg without one (a weight),
    whose gradient is then ``Partial`` on the batch's mesh dims: each rank
    holds the share of its rows.  Each result is sharded on the batch's
    mesh dims at ``out_batch[j]``, or ``Partial`` there when that is
    ``"partial"`` (a per-rank share of a sum), and replicated elsewhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    ref = like if is_dtensor(like) else next(a for a in args
                                             if is_dtensor(a))
    n = ref.device_mesh.ndim
    bd = batch_dims(like) if is_dtensor(like) else ()

    def pl(b):
        if b == "partial":
            return [Partial() if i in bd else Replicate() for i in range(n)]
        return [Shard(b) if i in bd and b is not None else Replicate()
                for i in range(n)]

    return local_call(
        fn, args, [pl(b) for b in batch], [pl(b) for b in out_batch],
        [pl(b) if b is not None else pl("partial") for b in batch])

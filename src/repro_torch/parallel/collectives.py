"""Mesh-level collective helpers for the explicit-communication paths.

Port of ``repro/parallel/collectives.py`` (:21-68).  The reference's
helpers run inside ``shard_map`` on each device's local block, naming a
mesh axis; these run on each rank's local tensor and take the mesh and the
axis, whose process group (``Mesh.group``) carries the collective:

- ``psum``/``pmean``/``pmax`` are ``all_reduce`` with SUM (divided by the
  group's size for the mean) or MAX;
- ``ring_permute`` is ``ppermute`` on a ring: ``batch_isend_irecv`` to the
  rank ``shift`` places on and from the one ``shift`` places back;
- ``all_gather_seq`` and ``reduce_scatter`` are the tiled ``all_gather``
  and ``psum_scatter``: ``all_gather_into_tensor`` and
  ``reduce_scatter_tensor``, with the dim moved first for any other dim.

An axis of size 1 makes no collective: each helper is the identity there
(a shift of 0 mod the axis size too, which covers it), so a world of one
NCCL rank never sends to itself.  They are used by the pipeline's ring
(``parallel/pipeline.py``) and the data-parallel gradient sync, plain or
int8-compressed (``parallel/compression.py``).

The plain helpers carry no gradient (``_all_reduce`` reduces a clone in
place, ``ring_permute`` receives into a fresh tensor).  Three autograd
Functions carry one, for a loss that every rank computes alike on the
replicated result (the training pipeline):

- ``ring_hop``: ``ring_permute(x, shift)``; its gradient goes back the
  way the activation came, ``ring_permute(g, -shift)``;
- ``reduce_from``: ``psum``; each rank's term reaches the loss once, as
  the sum, so its gradient is the sum's: the identity (an all-reduce
  there would count it once for every rank of the axis);
- ``copy_to``: the identity on a value every rank of the axis holds
  alike; each rank's use of it adds to the gradient, so the gradient is
  their ``psum``.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from ..tree import tree_map


def _all_reduce(x: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    if mesh.shape[axis] == 1:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=mesh.group(axis))
    return out


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    n = mesh.shape[axis]
    if n == 1:
        return x
    # divided by a tensor: a CUDA tensor divided by a Python number is
    # multiplied by the reciprocal instead, one rounding more
    return psum(x, mesh, axis) / torch.full((), n, dtype=x.dtype,
                                            device=x.device)


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)


def psum_tree(tree: Any, mesh, axis: str) -> Any:
    return tree_map(lambda x: psum(x, mesh, axis), tree)


def pmean_tree(tree: Any, mesh, axis: str) -> Any:
    return tree_map(lambda x: pmean(x, mesh, axis), tree)


def ring_permute(x: torch.Tensor, mesh, axis: str,
                 shift: int = 1) -> torch.Tensor:
    """The tensor of the rank ``shift`` places back along ``axis``: rank
    ``i`` sends ``x`` to ``(i + shift) % n``."""
    n = mesh.shape[axis]
    if shift % n == 0:
        return x
    group, i = mesh.group(axis), mesh.axis_index(axis)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (i + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (i - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return ring_permute(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return ring_permute(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, \
            None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axis), None, None


def ring_hop(x: torch.Tensor, mesh, axis: str,
             shift: int = 1) -> torch.Tensor:
    """``ring_permute`` under autograd: the gradient of the received tensor
    travels ``shift`` places back, to the rank that sent it."""
    return _RingHop.apply(x, mesh, axis, shift)


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``psum`` under autograd, for a sum every rank then uses alike: the
    gradient of each rank's term is the sum's gradient on that rank."""
    return _ReduceFrom.apply(x, mesh, axis)


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x``, the same on every rank of ``axis``, under autograd: its
    gradient is the ``psum`` of the ranks' gradients."""
    return _CopyTo.apply(x, mesh, axis)


def all_gather_seq(x: torch.Tensor, mesh, axis: str,
                   dim: int = 1) -> torch.Tensor:
    """The ranks' tensors along ``axis`` concatenated on ``dim``, in rank
    order (the tiled ``all_gather``)."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=mesh.group(axis))
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, mesh, axis: str,
                   dim: int = 0) -> torch.Tensor:
    """The ranks' tensors along ``axis`` summed, and this rank's block of
    the sum along ``dim`` (the tiled ``psum_scatter``)."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"{n} ways")
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM,
                               group=mesh.group(axis))
    return out.movedim(0, dim).contiguous()


def dp_gradient_sync(grads: Any, mesh, data_axes: Sequence[str],
                     compressor: Optional[Any] = None) -> Any:
    """Explicit data-parallel gradient all-reduce: the mean of each rank's
    gradients over the mesh axes of ``data_axes`` it has.

    With ``compressor`` (see :mod:`repro_torch.parallel.compression`) the
    all-reduce runs on the compressed representation.  ``grads`` itself is
    returned when the mesh has none of the axes.
    """
    axes = tuple(a for a in data_axes if a in mesh.axis_names)
    if not axes:
        return grads

    def one(x):
        if compressor is not None:
            return compressor.all_reduce(x, mesh, axes)
        for ax in axes:
            x = pmean(x, mesh, ax)
        return x

    return tree_map(one, grads)

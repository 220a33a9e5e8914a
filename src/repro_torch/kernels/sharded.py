"""The kernels on DTensors: each rank launches the hand-written kernel on its
local shard.

``kernels/ops.py`` sends a call here when an argument is a DTensor (a value
of ``core/mesh_executor.py``, or one laid out by
``parallel.sharding.shard``).  The inputs are first redistributed to
placements under which the product stays local to each shard, then each
rank calls the kernel's entry in ``ops`` on ``to_local()`` tensors, where
the wrapper launches the kernel and counts the launch, and the result is
wrapped back as a DTensor with the global shape.  A DTensor never reaches
``torch.matmul`` or a library attention on this path.

- ``matmul(x, y)``: rows of ``x`` stay sharded where they are
  (``Shard(0)``); every other placement of ``x``, and all of ``y``'s, are
  replicated first;
- ``flash_attention(q, k, v)``: batch (``Shard(0)``) and head
  (``Shard(1)``, where the mesh dimension divides both the query and the kv
  heads, so each shard keeps whole GQA groups) shardings of ``q`` stay, and
  ``k`` and ``v`` take the same placements; the sequence and head dims are
  replicated first.

A plain tensor beside a DTensor is taken as the full value, the same on
every rank.

The local matmul goes through the operator ``repro_torch::matmul`` (the
kernel's wrapper, defined with this module), whose FLOP formula (2 M N K
of the local shapes) lets ``torch.utils.flop_counter.FlopCounterMode``
count the kernel's work on each rank, as ``MeshExecutor.cost_analysis``
does.  Calls of ``ops.matmul`` on plain tensors never reach it.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import register_flop_formula

from . import matmul as _matmul
from . import refuse_grad

if not hasattr(torch.ops.repro_torch, "matmul"):
    @torch.library.custom_op("repro_torch::matmul", mutates_args=())
    def _matmul_op(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return _matmul.matmul(x, y)

    @_matmul_op.register_fake
    def _(x, y):
        return x.new_empty((x.shape[0], y.shape[1]))

    @register_flop_formula(torch.ops.repro_torch.matmul)
    def _flops(x_shape, y_shape, *args, out_shape=None, **kwargs):
        return 2 * x_shape[0] * x_shape[1] * y_shape[1]


def _as_dtensor(t: torch.Tensor, mesh) -> DTensor:
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _mesh(*ts) -> object:
    return next(t.device_mesh for t in ts if isinstance(t, DTensor))


def _local(fn: Callable, args: Sequence[DTensor], out_placements: Tuple,
           shape: Tuple[int, ...], mesh) -> DTensor:
    """``fn`` on the ranks' local tensors, wrapped as a DTensor of the
    global ``shape`` (contiguous) laid out by ``out_placements``."""
    out = fn(*(a.to_local() for a in args))
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(out, mesh, out_placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def matmul(x: torch.Tensor, y: torch.Tensor) -> DTensor:
    """``x @ y`` with the matmul kernel on each rank's rows of ``x``."""
    refuse_grad("matmul", x, y,
                remedy="call it under torch.no_grad(); the Fig. 2 workload "
                       "needs no gradient")
    mesh = _mesh(x, y)
    x, y = _as_dtensor(x, mesh), _as_dtensor(y, mesh)
    xp = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    x = x.redistribute(mesh, xp)
    y = y.redistribute(mesh, [Replicate()] * mesh.ndim)
    return _local(torch.ops.repro_torch.matmul, (x, y), xp,
                  (x.shape[0], y.shape[1]), mesh)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kernel: Callable) -> DTensor:
    """Attention of ``q`` over ``k, v`` with ``kernel`` (a callable of q, k,
    v) on each rank's batch rows and heads."""
    mesh = _mesh(q, k, v)
    q, k, v = (_as_dtensor(t, mesh) for t in (q, k, v))
    H, KH = q.shape[1], k.shape[1]
    keep = []
    for dim, p in enumerate(q.placements):
        n = mesh.size(dim)
        heads = p == Shard(1) and H % n == 0 and KH % n == 0
        keep.append(p if p == Shard(0) or heads else Replicate())
    keep = tuple(keep)
    q, k, v = (t.redistribute(mesh, keep) for t in (q, k, v))
    return _local(kernel, (q, k, v), keep, tuple(q.shape), mesh)

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
  replicated first.  Under autograd the local call goes through the
  ``FlashAttention`` Function (``ops.flash_attention`` on the local
  tensors: the backward kernel on each rank's heads); ``to_local`` and
  ``from_local`` carry the gradient back, each of q, k and v split as its
  output is, so no gradient is a partial sum.
  ``heads_call`` runs any attention so, a decode step's over its cache
  (``models/layers.py::attention_scores``) among them;
- ``ssm_scan(x, dt, B, C, A, h0)``: the batch (``Shard(0)`` of ``x``) and
  the channels (``Shard(2)`` of ``x``, the reference's ``ssm_inner``, where
  the mesh dimension divides them) stay sharded: ``x``, ``dt`` and the
  state are split with them, ``A``'s rows with the channels, ``B`` and
  ``C`` with the batch and replicated over the channels.  Under autograd
  the local call goes through ``SSMScan`` (the backward kernel on each
  rank's channels).  ``B`` and ``C``'s gradients are sums over every
  channel and ``A``'s over every batch row, so a rank's are shares of
  them: they come back as ``Partial`` on the mesh dims that split what
  they are summed over.

A plain tensor beside a DTensor is taken as the full value, the same on
every rank.  ``local_calls`` counts the kernels' calls made here, so a run
can show that its launches went through this module; the backward passes of
the attention and of the scan are counted by a hook on each local output.

The local matmul goes through the operator ``repro_torch::matmul``
(``kernels/operators.py``: the kernel's wrapper), whose FLOPs (2 M N K of
the local shapes) ``launch.costs.Counter`` counts on each rank, as
``MeshExecutor.cost_analysis`` does; the attention and the scan reach
their operators through ``ops`` when a count runs.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..parallel.sharding import local_call
from . import needs_grad, operators, refuse_grad

local_calls = {"flash_attention": 0, "flash_attention_backward": 0,
               "ssm_scan": 0, "ssm_scan_backward": 0}

def _as_dtensor(t: torch.Tensor, mesh) -> DTensor:
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _mesh(*ts) -> object:
    return next(t.device_mesh for t in ts if isinstance(t, DTensor))


def matmul(x: torch.Tensor, y: torch.Tensor) -> DTensor:
    """``x @ y`` with the matmul kernel on each rank's rows of ``x``."""
    refuse_grad("matmul", x, y,
                remedy="call it under torch.no_grad(); the Fig. 2 workload "
                       "needs no gradient")
    mesh = _mesh(x, y)
    x, y = _as_dtensor(x, mesh), _as_dtensor(y, mesh)
    xp = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    return local_call(lambda x, y: (operators.matmul(x, y),),
                      [x, y], [xp, [Replicate()] * mesh.ndim], [xp],
                      shapes=[(x.shape[0], y.shape[1])])[0]


def heads_call(fn: Callable, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, head_dim: int, **rows) -> DTensor:
    """``fn(q, k, v, **rows)`` (an attention over plain tensors) on each
    rank's batch rows and heads: the batch (dim 0) stays sharded where
    ``q`` has it, the heads (``head_dim``) where the mesh dimension divides
    both the query and the kv heads, so each shard keeps whole GQA groups;
    every other dim is replicated first.  ``rows`` are per-row tensors (a
    decode step's positions and lengths), split with the batch."""
    mesh = _mesh(q, k, v)
    q = _as_dtensor(q, mesh)
    H, KH = q.shape[head_dim], k.shape[head_dim]
    keep, split_rows = [], []
    for dim, p in enumerate(q.placements):
        n = mesh.size(dim)
        heads = p == Shard(head_dim) and H % n == 0 and KH % n == 0
        keep.append(p if p == Shard(0) or heads else Replicate())
        split_rows.append(Shard(0) if p == Shard(0) else Replicate())
    names = [name for name, t in rows.items() if t is not None]

    def body(q, k, v, *extra):
        return (fn(q, k, v, **dict(zip(names, extra))),)
    return local_call(body, [q, k, v] + [rows[n] for n in names],
                      [keep] * 3 + [split_rows] * len(names), [keep],
                      shapes=[q.shape])[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kernel: Callable) -> DTensor:
    """Attention of ``q`` over ``k, v`` (B, H, S, D) with ``kernel`` (a
    callable of q, k, v) on each rank's batch rows and heads."""
    local_calls["flash_attention"] += 1

    def counted(q, k, v):
        out = kernel(q, k, v)
        if needs_grad(q, k, v):
            out.register_hook(_count_flash_backward)
        return out
    return heads_call(counted, q, k, v, 1)


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor,
             h0: Optional[torch.Tensor], scan: Callable
             ) -> Tuple[DTensor, DTensor]:
    """``scan(x, dt, B, C, A, h0) -> (y, h_final)`` (the kernel's entry in
    ``ops``, with its state) on each rank's batch rows and channels; see
    the module docstring for the placements and gradients."""
    mesh = _mesh(x, dt, B, C, A, h0)
    x = _as_dtensor(x, mesh)
    R, P = Replicate(), Partial()
    # per mesh dim: x and dt, B and C, A, the state; B and C's, A's grads
    layout = []
    for dim, p in enumerate(x.placements):
        if p == Shard(0):                                   # batch rows
            layout.append((Shard(0), Shard(0), R, Shard(0), Shard(0), P))
        elif p == Shard(2) and x.shape[2] % mesh.size(dim) == 0:
            layout.append((Shard(2), R, Shard(0), Shard(1), P, Shard(0)))
        else:
            layout.append((R,) * 6)
    seq, vec, mat, state, grad_vec, grad_mat = (list(c) for c in
                                                zip(*layout))

    def body(*loc):
        y, h = scan(*loc)
        local_calls["ssm_scan"] += 1
        if needs_grad(*loc):
            y.register_hook(_count_backward)
        return y, h
    return local_call(body, [x, dt, B, C, A, h0],
                      [seq, seq, vec, vec, mat, state], [seq, state],
                      [seq, seq, grad_vec, grad_vec, grad_mat, state],
                      shapes=[x.shape, (x.shape[0], x.shape[2],
                                        A.shape[1])])


def _count_backward(grad):
    local_calls["ssm_scan_backward"] += 1
    return grad


def _count_flash_backward(grad):
    local_calls["flash_attention_backward"] += 1
    return grad

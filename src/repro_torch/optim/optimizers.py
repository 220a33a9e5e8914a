"""Optimizers over trees of tensors, updating in place.

Port of ``repro/optim/optimizers.py``: the same formulas in the same order,
float32 moments whatever the parameters' dtype, and the same state trees
(``{"step", "m", "v"}`` for AdamW, Adafactor's ``vr``/``vc`` factored by
shape, a 0-d int32 ``step``), so a checkpoint of either package restores
into the other.

The reference is functional: ``update`` returns the updates and a new
state, and the jitted train step donates the old buffers
(``launch/train.py:124``), so XLA updates them in place.  PyTorch has no
donation, so here ``update(grads, state, params)`` does that work in place:
it advances ``state`` (and returns it), adds each update into its
parameter, and scales float32 ``grads`` in place when it clips.  New copies
of ``m``, ``v`` and the gradients would cost three more parameter-sized
trees (at qwen2-7b's 2.95 B parameters of 8 layers, 35 GB on top of the
step's 47 GB).  Each leaf's update is computed with at most two temporaries
of its size.  The per-step scalars (learning rate, bias corrections) stay
0-d float32 tensors on the device: no host sync.

On DTensor parameters (the launchers' world path) the state takes each
parameter's layout: ``m`` and ``v`` are ``zeros_like`` it, Adafactor's
factored ``vr`` and ``vc`` keep the placements of the dims they keep (a
shard of the dim they average over becomes a replica), and every update
runs in place on each rank's shard; the per-step scalars stay plain 0-d
tensors, which DTensor takes as replicated.  Adafactor's row and column
means over a sharded dim are sums over the ranks (DTensor's ``Partial``),
reduced where they meet the state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..parallel.sharding import is_dtensor
from ..tree import tree_leaves, tree_map

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


def _step_counter(params: Any) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _zeros(like: torch.Tensor, drop: Optional[int] = None) -> torch.Tensor:
    """float32 zeros of ``like``'s shape, or of it without dim ``drop``, in
    ``like``'s layout when it is a DTensor (without the dropped dim)."""
    if drop is None:
        return torch.zeros_like(like, dtype=torch.float32)
    drop %= like.dim()
    shape = like.shape[:drop] + like.shape[drop + 1:]
    z = torch.zeros(shape, dtype=torch.float32, device=like.device)
    if not is_dtensor(like):
        return z
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    pl = [Replicate() if q == Shard(drop)
          else Shard(q.dim - 1) if isinstance(q, Shard) and q.dim > drop
          else q for q in like.placements]
    return distribute_tensor(z, like.device_mesh, pl, src_data_rank=None)


def global_norm(tree: Any) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in leaves))


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """``tree`` scaled to global norm at most ``max_norm``, as float32, and
    its norm before scaling.  float32 leaves are scaled in place."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float().mul_(scale), tree), norm


def _add_update(p: torch.Tensor, u: torch.Tensor, lr: torch.Tensor) -> None:
    """``p += -lr * u``: computed in float32 and rounded once into ``p``'s
    dtype, as the reference's ``(p + u).astype(p.dtype)``."""
    p.sub_(lr * u)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Schedule = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0

    def init(self, params: Any) -> Dict:
        return {"step": _step_counter(params),
                "m": tree_map(_zeros, params),
                "v": tree_map(_zeros, params)}

    @torch.no_grad()
    def update(self, grads: Any, state: Dict, params: Any) -> Dict:
        """One step, in place: ``state`` advanced (and returned), each
        parameter updated."""
        state["step"].add_(1)
        step = state["step"]
        if self.clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, self.clip_norm)
        else:
            grads = tree_map(lambda g: g.float(), grads)
        c1 = 1 - torch.pow(self.b1, step.float())
        c2 = 1 - torch.pow(self.b2, step.float())
        lr = _lr_at(self.lr, step)

        def one(p, g, m, v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (m / c1).div_((v / c2).sqrt_().add_(self.eps))
            if self.weight_decay:
                u.add_(p.float(), alpha=self.weight_decay)
            _add_update(p, u, lr)

        tree_map(one, params, grads, state["m"], state["v"])
        return state


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Factored second-moment optimizer (Shazeer & Stern, 2018): O(n+m)
    state for an (n, m) matrix."""
    lr: Schedule = 1e-2
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    min_dim_factored: int = 128

    def _factored(self, shape) -> bool:
        return len(shape) >= 2 and shape[-1] >= self.min_dim_factored \
            and shape[-2] >= self.min_dim_factored

    def init(self, params: Any) -> Dict:
        def one(p):
            if self._factored(p.shape):
                return {"vr": _zeros(p, -1), "vc": _zeros(p, -2)}
            return {"v": _zeros(p)}
        return {"step": _step_counter(params), "v": tree_map(one, params)}

    @torch.no_grad()
    def update(self, grads: Any, state: Dict, params: Any) -> Dict:
        state["step"].add_(1)
        step = state["step"]
        t = step.float()
        beta = 1.0 - torch.pow(t, -self.decay)
        lr = _lr_at(self.lr, step)

        def one(p, g, v):
            g = g.float()
            g2 = g * g + self.eps
            if "vr" in v:
                v["vr"].mul_(beta).add_(g2.mean(dim=-1).mul_(1 - beta))
                v["vc"].mul_(beta).add_(g2.mean(dim=-2).mul_(1 - beta))
                vr, vc = v["vr"], v["vc"]
                rfac = torch.rsqrt(vr / vr.mean(dim=-1, keepdim=True)
                                   + self.eps)
                cfac = torch.rsqrt(vc + self.eps)
                u = g * rfac[..., None] * cfac[..., None, :]
            else:
                v["v"].mul_(beta).add_(g2.mul_(1 - beta))
                u = g * torch.rsqrt(v["v"] + self.eps)
            # update clipping (RMS of update limited to clip_threshold)
            rms = torch.sqrt(torch.mean(u * u) + self.eps)
            u.div_(torch.clamp(rms / self.clip_threshold, min=1.0))
            _add_update(p, u, lr)

        tree_map(one, params, grads, state["v"])
        return state


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: Schedule = 1e-2
    momentum: float = 0.0

    def init(self, params: Any) -> Dict:
        st = {"step": _step_counter(params)}
        if self.momentum:
            st["m"] = tree_map(_zeros, params)
        return st

    @torch.no_grad()
    def update(self, grads: Any, state: Dict, params: Any) -> Dict:
        state["step"].add_(1)
        lr = _lr_at(self.lr, state["step"])
        if self.momentum:
            def one(p, g, m):
                m.mul_(self.momentum).add_(g.float())
                _add_update(p, m, lr)
            tree_map(one, params, grads, state["m"])
        else:
            tree_map(lambda p, g: _add_update(p, g.float(), lr), params,
                     grads)
        return state

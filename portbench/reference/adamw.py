"""AdamW with the global-norm clip, as the configurations state it (the
optimizer ``kind`` "AdamW")."""
from __future__ import annotations

from typing import Dict

import torch


class Optimizer:
    """AdamW with the global-norm clip, the configuration file's settings:
    m ← b1 m + (1 − b1) g, v ← b2 v + (1 − b2) g², p ← p − lr ((m / c1) /
    (√(v / c2) + eps) + wd p), c = 1 − b^t, g first scaled by min(1,
    clip / (‖g‖ + 1e-9))."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: Dict):
        self.opt = opt
        self.t = 0
        self.m = {p: torch.zeros_like(t) for p, t in params.items()}
        self.v = {p: torch.zeros_like(t) for p, t in params.items()}

    @torch.no_grad()
    def step(self, params, grads) -> Dict[str, torch.Tensor]:
        """Updates ``params`` in place; returns the clipped gradients."""
        o = self.opt
        self.t += 1
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp(o["clip_norm"] / (norm + 1e-9), max=1.0)
        c1 = 1 - o["b1"] ** self.t
        c2 = 1 - o["b2"] ** self.t
        for p, g in grads.items():
            g.mul_(scale)
            m, v = self.m[p], self.v[p]
            m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            v.mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
            u = (m / c1).div_((v / c2).sqrt_().add_(o["eps"]))
            u.add_(params[p], alpha=o["weight_decay"])
            params[p].sub_(u, alpha=o["lr"])
        return grads

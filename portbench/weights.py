"""The benchmark's weights: drawn on the device from ``--seed``, in a few
large calls, in float32, the type the configurations keep their parameters
in.

One generator on the device draws every normal leaf in one pass over a
flat buffer (in calls of at most 2**30 values), then every ``mamba_dt``
leaf; each leaf is a view of its buffer, scaled in place.  The same seed on
the same device gives the same values, so the reference draws them again
for itself after the program's state is freed, and ``traffic/train.py``
draws them again to measure how far the program's steps moved each leaf.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .tree import leaves

_ALIGN = 128          # elements: every leaf starts 512 bytes into its buffer
_CALL = 1 << 30       # values a call draws at most


def seed64(seed: int) -> int:
    """A generator seed from any whole number, negative or past 64 bits."""
    return (seed * 0x9E3779B97F4A7C15 + 0x5EED) % (1 << 63)


def _flat(n: int, fill, gen, device) -> torch.Tensor:
    buf = torch.empty(n, dtype=torch.float32, device=device)
    for start in range(0, n, _CALL):
        fill(buf[start:start + _CALL], gen)
    return buf


def draw(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` of ``cfg``'s leaves (``tree.leaves``), float32 on
    ``device``."""
    device = torch.device(device)
    specs = leaves(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed64(seed))
    out: Dict[str, torch.Tensor] = {}
    for kind, fill in (("normal", lambda t, g: t.normal_(generator=g)),
                       ("mamba_dt", lambda t, g: t.uniform_(generator=g))):
        group = [s for s in specs if s.init == kind]
        offsets, n = [], 0
        for s in group:
            offsets.append(n)
            n += -(-s.numel // _ALIGN) * _ALIGN
        if not group:
            continue
        buf = _flat(n, fill, gen, device)
        for s, off in zip(group, offsets):
            t = buf[off:off + s.numel].view(s.shape)
            if kind == "normal":
                t.mul_(s.std())
            else:
                lo, hi = math.log(1e-3), math.log(0.1)
                dt = t.mul_(hi - lo).add_(lo).exp_()
                t.add_(torch.log(-torch.expm1(-dt)))     # inverse softplus
            out[s.path] = t
    for s in specs:
        if s.init == "zeros":
            out[s.path] = torch.zeros(s.shape, device=device)
        elif s.init == "ones":
            out[s.path] = torch.ones(s.shape, device=device)
        elif s.init == "mamba_A":
            a = torch.arange(1, s.shape[-1] + 1, dtype=torch.float32,
                             device=device)
            out[s.path] = torch.log(a).expand(s.shape).contiguous()
    return {s.path: out[s.path] for s in specs}

"""Public entry points for the port's kernels.

Port of ``repro/kernels/ops.py``.  ``impl="kernel"`` (the default) calls the
hand-written kernel's wrapper, which launches the kernel for CUDA tensors
and uses the plain version for CPU tensors; ``impl="ref"`` calls the plain
version on any device.  With a DTensor argument, ``matmul``,
``flash_attention`` and ``ssm_scan`` run the wrapper (or its autograd
Function) on each rank's local shard (``kernels/sharded.py``), and
``impl="ref"`` the plain version there.  While a
count runs (``launch.costs.Counter``), or for fake tensors, a call goes
through the kernel's operator (``kernels/operators.py``), which calls the
same wrapper and which the count sees (``kernels.operator_route``).
"""
from __future__ import annotations

import sys
from typing import Optional

import torch

from . import flash_attention as _flash
from . import matmul as _matmul
from . import needs_grad, operator_route, ref
from . import ssm_scan as _ssm_scan


def _sharded(*tensors):
    """``kernels.sharded`` when an argument is a DTensor, else None.  No
    DTensor exists before ``torch.distributed.tensor`` is imported, so a
    process that never imported it pays no import here."""
    dt = sys.modules.get("torch.distributed.tensor")
    if dt is None or not any(isinstance(t, dt.DTensor) for t in tensors):
        return None
    from . import sharded
    return sharded


def matmul(x: torch.Tensor, y: torch.Tensor, *,
           impl: str = "kernel") -> torch.Tensor:
    if impl == "ref":
        return ref.matmul(x, y)
    if impl == "kernel":
        sharded = _sharded(x, y)
        if sharded is not None:
            return sharded.matmul(x, y)
        op = operator_route(x, y)
        if op is not None and not needs_grad(x, y):
            return op.matmul(x, y)
        return _matmul.matmul(x, y)
    raise ValueError(f"unknown impl {impl!r} (expected 'kernel' or 'ref')")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, impl: str = "kernel") -> torch.Tensor:
    """Attention of ``q (B, H, Sq, D)`` over ``k, v (B, KH, Sk, D)``; see
    :func:`repro_torch.kernels.flash_attention.flash_attention`.  Mirrors
    ``repro.kernels.ops.flash_attention`` without its TPU block sizes: the
    kernel takes any ``Sq`` and ``Sk``.  When autograd tracks the call,
    ``impl="kernel"`` goes through the autograd Function
    :class:`~repro_torch.kernels.flash_attention.FlashAttention` (the same
    kernel forward, the backward kernel)."""
    if impl == "ref":
        sharded = _sharded(q, k, v)
        if sharded is not None:
            return sharded.heads_call(
                lambda q, k, v: ref.attention(q, k, v, causal=causal),
                q, k, v, 1)
        return ref.attention(q, k, v, causal=causal)
    if impl == "kernel":
        sharded = _sharded(q, k, v)
        if sharded is not None:
            return sharded.flash_attention(
                q, k, v, lambda q, k, v: flash_attention(q, k, v,
                                                         causal=causal))
        if needs_grad(q, k, v):
            return _flash.FlashAttention.apply(q, k, v, causal)
        op = operator_route(q, k, v)
        if op is not None:
            return op.flash_attention(q, k, v, causal, False)[0]
        return _flash.flash_attention(q, k, v, causal=causal)
    raise ValueError(f"unknown impl {impl!r} (expected 'kernel' or 'ref')")


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *,
             return_state: bool = False, impl: str = "kernel"):
    """Selective scan; see :func:`repro_torch.kernels.ssm_scan.ssm_scan`.

    ``ssm_scan(x, dt, B, C, A)`` mirrors ``repro.kernels.ops.ssm_scan``
    (zero initial state, ``y`` in ``x.dtype``); ``h0`` and ``return_state``
    carry the state the model needs.  When autograd tracks the call,
    ``impl="kernel"`` goes through the autograd Function
    :class:`~repro_torch.kernels.ssm_scan.SSMScan` on every device (the
    same kernel forward, the backward kernel); ``impl="ref"`` is autograd
    of the plain scan."""
    if impl == "ref":
        sharded = _sharded(x, dt, B, C, A, h0)
        if sharded is not None:
            y, h = sharded.ssm_scan(
                x, dt, B, C, A, h0,
                lambda *a: ref.ssm_scan(*a, return_state=True))
            return (y, h) if return_state else y
        return ref.ssm_scan(x, dt, B, C, A, h0, return_state=return_state)
    if impl == "kernel":
        sharded = _sharded(x, dt, B, C, A, h0)
        if sharded is not None:
            y, h = sharded.ssm_scan(
                x, dt, B, C, A, h0,
                lambda *a: ssm_scan(*a, return_state=True))
            return (y, h) if return_state else y
        if needs_grad(x, dt, B, C, A, h0):
            y, h = _ssm_scan.SSMScan.apply(x, dt, B, C, A, h0)
            return (y, h) if return_state else y
        op = operator_route(x, dt, B, C, A, h0)
        if op is not None:
            y, h, _ = op.ssm_scan(x, dt, B, C, A, h0, False)
            return (y, h) if return_state else y
        return _ssm_scan.ssm_scan(x, dt, B, C, A, h0,
                                  return_state=return_state)
    raise ValueError(f"unknown impl {impl!r} (expected 'kernel' or 'ref')")

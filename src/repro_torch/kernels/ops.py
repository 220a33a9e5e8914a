"""Public entry points for the port's kernels.

Port of ``repro/kernels/ops.py``.  ``impl="kernel"`` (the default) calls the
hand-written kernel's wrapper, which launches the kernel for CUDA tensors
and uses the plain version for CPU tensors; ``impl="ref"`` calls the plain
version on any device.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as _flash
from . import matmul as _matmul
from . import needs_grad, ref
from . import ssm_scan as _ssm_scan


def matmul(x: torch.Tensor, y: torch.Tensor, *,
           impl: str = "kernel") -> torch.Tensor:
    if impl == "ref":
        return ref.matmul(x, y)
    if impl == "kernel":
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
    kernel forward, a backward in torch ops)."""
    if impl == "ref":
        return ref.attention(q, k, v, causal=causal)
    if impl == "kernel":
        if needs_grad(q, k, v):
            return _flash.FlashAttention.apply(q, k, v, causal)
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
        return ref.ssm_scan(x, dt, B, C, A, h0, return_state=return_state)
    if impl == "kernel":
        if needs_grad(x, dt, B, C, A, h0):
            y, h = _ssm_scan.SSMScan.apply(x, dt, B, C, A, h0)
            return (y, h) if return_state else y
        return _ssm_scan.ssm_scan(x, dt, B, C, A, h0,
                                  return_state=return_state)
    raise ValueError(f"unknown impl {impl!r} (expected 'kernel' or 'ref')")

"""Plain PyTorch versions of the port's kernels (the allclose targets).

Port of ``repro/kernels/ref.py``.  Each function here is the kernel's plain
version: the kernel wrapper runs it for tensors on the CPU, and
``chip_smoke.py`` and the GPU tests hold the kernel against it on the card.
"""
from __future__ import annotations

import torch


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(M, K) @ (K, N) -> (M, N)`` in ``x.dtype``, computed in float32.

    On the card a float32 product may run in TF32, which keeps about three
    decimal digits and is no reference for an IEEE float32 kernel; so this
    refuses to run while ``torch.backends.cuda.matmul.allow_tf32`` is set.
    """
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "ref.matmul needs torch.backends.cuda.matmul.allow_tf32 = False")
    return (x.float() @ y.float()).to(x.dtype)

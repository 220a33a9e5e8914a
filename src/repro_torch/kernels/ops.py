"""Public entry points for the port's kernels.

Port of ``repro/kernels/ops.py``.  ``impl="kernel"`` (the default) calls the
hand-written kernel's wrapper, which launches the kernel for CUDA tensors
and uses the plain version for CPU tensors; ``impl="ref"`` calls the plain
version on any device.  Flash attention and the SSM scan are not ported yet
(ROADMAP §2).
"""
from __future__ import annotations

import torch

from . import matmul as _matmul
from . import ref


def matmul(x: torch.Tensor, y: torch.Tensor, *,
           impl: str = "kernel") -> torch.Tensor:
    if impl == "ref":
        return ref.matmul(x, y)
    if impl == "kernel":
        return _matmul.matmul(x, y)
    raise ValueError(f"unknown impl {impl!r} (expected 'kernel' or 'ref')")

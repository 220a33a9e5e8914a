"""The hand-written CUDA matmul kernels and their wrapper.

Port of ``repro/kernels/matmul_pallas.py::matmul``, the compute payload of
the paper's Fig. 2 benchmark: ``(M, K) @ (K, N) -> (M, N)`` in ``x.dtype``
with a float32 sum.  Two routes, chosen by :func:`route` from the dtype, the
shape and the pointers' alignment:

- ``"wgmma"`` (``csrc/matmul_wgmma.cu``): bf16 with ``K % 8 == 0`` and
  ``N % 8 == 0`` and 16-byte aligned pointers (TMA needs 16-byte rows and
  bases), on the tensor cores;
- ``"simt"`` (``csrc/matmul.cu``): float32, which stays IEEE float32 on the
  CUDA cores (the tensor cores' float32 input is TF32, about three decimal
  digits), and every other bf16 product.

The simt kernel has two load variants, chosen by :func:`variant` from the
same facts: ``"vector"`` (float32 with ``N % 4 == 0`` and 16-byte aligned
pointers: y's tiles move as 16-byte copies and the output rows are stored
16 bytes at a time) and ``"scalar"`` (everything else, bf16 included).

The sources' headers say how the TPU kernel's blocking translates and what
bounds each kernel on the H100.

For tensors on the CPU the wrapper returns the plain version
(:func:`repro_torch.kernels.ref.matmul`).  For CUDA tensors it launches a
kernel or raises; it never falls back.  ``matmul.launches`` counts every
launch, ``matmul.route_launches`` the launches of each route and
``matmul.variant_launches`` those of each load variant, so a run can show
that its work went through the kernels.
"""
from __future__ import annotations

import threading

import torch

from . import _build, ref, refuse_grad

_ENTRY = {("simt", "vector", torch.float32): "repro_matmul_f32",
          ("simt", "scalar", torch.float32): "repro_matmul_f32_scalar",
          ("simt", "scalar", torch.bfloat16): "repro_matmul_bf16",
          ("wgmma", "tma", torch.bfloat16): "repro_matmul_bf16_wgmma"}
ROUTES = ("wgmma", "simt")
VARIANTS = ("tma", "vector", "scalar")
_INT_MAX = 2 ** 31 - 1
_launch_lock = threading.Lock()   # guards matmul.launches across workers


def route(dtype: torch.dtype, N: int, K: int, *, aligned: bool = True) -> str:
    """The kernel that takes ``(M, K) @ (K, N)`` in ``dtype`` on the card;
    ``aligned``: x and y start on 16-byte boundaries."""
    if dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0 and aligned:
        return "wgmma"
    return "simt"


def variant(dtype: torch.dtype, N: int, K: int, *,
            aligned: bool = True) -> str:
    """How the kernel that :func:`route` picks loads its tiles: ``"tma"``
    for wgmma; ``"vector"`` or ``"scalar"`` for simt."""
    if route(dtype, N, K, aligned=aligned) == "wgmma":
        return "tma"
    return ("vector" if dtype == torch.float32 and N % 4 == 0 and aligned
            else "scalar")


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` for row-major 2-D ``x (M, K)`` and ``y (K, N)`` of one dtype
    (float32 or bfloat16 on the card) on one device.  It raises when a
    gradient is asked of it, on any device: the kernel has no backward."""
    refuse_grad("matmul", x, y,
                remedy="call it under torch.no_grad(); the Fig. 2 workload "
                       "needs no gradient")
    if x.dim() != 2 or y.dim() != 2:
        raise ValueError(f"matmul takes 2-D tensors, got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    if x.shape[1] != y.shape[0]:
        raise ValueError(f"inner dims differ: {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    if x.dtype != y.dtype:
        raise TypeError(f"dtypes differ: {x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"devices differ: {x.device} and {y.device}")
    if x.device.type == "cpu":
        return ref.matmul(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"no matmul kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the matmul kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("the matmul kernel takes contiguous tensors")
    (M, K), N = x.shape, y.shape[1]
    if max(M, N, K) > _INT_MAX:
        raise ValueError(f"dims {M}, {N}, {K} exceed the kernel's int range")
    aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    path = route(x.dtype, N, K, aligned=aligned)
    loads = variant(x.dtype, N, K, aligned=aligned)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, _ENTRY[path, loads, x.dtype])(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K,
        x.device.index, stream)
    _build.check(err, f"matmul kernel launch ({path}, {loads})")
    with _launch_lock:
        matmul.launches += 1
        matmul.route_launches[path] += 1
        matmul.variant_launches[loads] += 1
    return out


matmul.launches = 0
matmul.route_launches = dict.fromkeys(ROUTES, 0)
matmul.variant_launches = dict.fromkeys(VARIANTS, 0)

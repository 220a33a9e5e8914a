"""The hand-written CUDA flash-attention kernels and their wrapper.

Port of ``repro/kernels/flash_attention.py::flash_attention``: forward
attention of ``q (B, H, Sq, D)`` over ``k, v (B, KH, Sk, D)`` with an online
softmax in float32, GQA by kv head ``h // (H // KH)`` and a top-left causal
mask.  Unlike the TPU kernel it takes any ``Sq`` and ``Sk`` (the served
prompts are 4-12 tokens long).  Two routes, chosen by :func:`route` from
the dtype, the head dim and the pointers' alignment:

- ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``): bf16 with ``D % 8 == 0``
  and 16-byte aligned q, k and v (TMA needs 16-byte rows and bases), on the
  tensor cores;
- ``"simt"`` (``csrc/flash_attention.cu``): float32, which stays IEEE
  float32 on the CUDA cores (the tensor cores' float32 input is TF32, about
  three decimal digits), and every other bf16 call.

The sources' headers say how the TPU kernel translates and what bounds each
kernel on the H100.

For tensors on the CPU the wrapper returns the plain version
(:func:`repro_torch.kernels.ref.attention`).  For CUDA tensors it launches a
kernel or raises; it never falls back.  ``flash_attention.launches`` counts
every launch and ``flash_attention.route_launches`` the launches of each
route, so a run can show that its work went through the kernels.
"""
from __future__ import annotations

import threading

import torch

from . import _build, ref

_ENTRY = {("simt", torch.float32): "repro_flash_attention_f32",
          ("simt", torch.bfloat16): "repro_flash_attention_bf16",
          ("wgmma", torch.bfloat16): "repro_flash_attention_bf16_wgmma"}
ROUTES = ("wgmma", "simt")
MAX_HEAD_DIM = 128
_INT_MAX = 2 ** 31 - 1
_MAX_GRID_YZ = 65535       # heads and batch are the grid's y and z
_launch_lock = threading.Lock()   # guards flash_attention.launches


def route(dtype: torch.dtype, D: int, *, aligned: bool = True) -> str:
    """The kernel that takes head dim ``1 <= D <= 128`` in ``dtype`` on the
    card; ``aligned``: q, k and v start on 16-byte boundaries."""
    return ("wgmma" if dtype == torch.bfloat16 and D % 8 == 0 and aligned
            else "simt")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention of ``q (B, H, Sq, D)`` over ``k, v (B, KH, Sk, D)`` with
    ``H % KH == 0``; returns ``(B, H, Sq, D)`` in ``q.dtype``.

    On the card q, k and v are float32 or bfloat16, all of one dtype,
    contiguous, with ``1 <= D <= 128``.  ``Sk == 0`` gives zeros.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, Sq, D) and k, v one (B, KH, Sk, "
                         f"D) shape, got {tuple(q.shape)}, {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k and v must be (B, KH, Sk, D) with B = {B} and "
                         f"D = {D}, got {tuple(k.shape)}")
    if KH < 1 or H % KH != 0:
        raise ValueError(f"the query heads ({H}) must be a multiple of the "
                         f"kv heads ({KH})")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must share one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, "
                         f"{v.device}")
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the flash_attention kernel takes float32 or "
                        f"bfloat16, not {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the flash_attention kernel takes contiguous "
                         "tensors")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"the flash_attention kernel takes head dims 1 <= D "
                         f"<= {MAX_HEAD_DIM}, got D = {D}")
    if max(B, H) > _MAX_GRID_YZ or max(Sq, Sk) > _INT_MAX:
        raise ValueError(f"shape {(B, H, Sq, Sk)} exceeds the kernel's grid")
    path = route(q.dtype, D,
                 aligned=all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    out = torch.empty_like(q)
    if B and Sq:
        lib = _build.library()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, _ENTRY[path, q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KH, Sq, Sk, D, int(causal), q.device.index, stream)
        _build.check(err, f"flash_attention kernel launch ({path})")
        with _launch_lock:
            flash_attention.launches += 1
            flash_attention.route_launches[path] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)

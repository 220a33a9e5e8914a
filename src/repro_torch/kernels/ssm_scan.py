"""The hand-written CUDA selective-scan kernel (``csrc/ssm_scan.cu``) and
its wrapper.

Port of ``repro/kernels/ssm_scan.py::ssm_scan``, extended with what
``repro/models/ssm.py::selective_scan`` carries: an initial state ``h0`` and
the final state.  The source's header says how the TPU kernel translates
and what bounds the kernel on the H100.

For tensors on the CPU the wrapper returns the plain version
(:func:`repro_torch.kernels.ref.ssm_scan`).  For CUDA tensors it launches
the kernel or raises; it never falls back.  ``ssm_scan.launches`` counts the
kernel's launches, so a run can show that its work went through the kernel.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from . import _build, ref, refuse_grad

_ENTRY = {torch.float32: "repro_ssm_scan_f32",
          torch.bfloat16: "repro_ssm_scan_bf16"}
MAX_STATE = 32             # N: one channel's states share one warp
_INT_MAX = 2 ** 31 - 1
_MAX_BATCH = 65535         # the batch is the grid's y dimension
_launch_lock = threading.Lock()   # guards ssm_scan.launches across workers


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *,
             return_state: bool = False):
    """Selective scan of ``x, dt (Bsz, S, D)``, ``B, C (Bsz, S, N)`` with
    ``A (D, N)`` from ``h0 (Bsz, D, N)`` (zeros when None).

    Returns ``y (Bsz, S, D)`` in ``x.dtype`` and, with ``return_state``,
    also the float32 final state ``(Bsz, D, N)`` (``h0`` when ``S == 0``).
    On the card ``x, dt, B, C`` are float32 or bfloat16, all of one dtype,
    ``A`` and ``h0`` float32, every tensor contiguous, and ``1 <= N <= 32``.
    It raises when a gradient is asked of it, on any device: the kernel has
    no backward yet.
    """
    refuse_grad("ssm_scan", x, dt, B, C, A, h0,
                remedy="Mamba1 training on the card, a gradient through the "
                       "scan, is ROADMAP §1 item 10; on the CPU "
                       "repro_torch.kernels.ops.ssm_scan differentiates the "
                       "plain version")
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"x and dt must be (Bsz, S, D), got "
                         f"{tuple(x.shape)} and {tuple(dt.shape)}")
    Bsz, S, D = x.shape
    if A.dim() != 2 or A.shape[0] != D:
        raise ValueError(f"A must be (D, N) with D = {D}, got "
                         f"{tuple(A.shape)}")
    N = A.shape[1]
    if B.shape != (Bsz, S, N) or C.shape != (Bsz, S, N):
        raise ValueError(f"B and C must be {(Bsz, S, N)}, got "
                         f"{tuple(B.shape)} and {tuple(C.shape)}")
    if h0 is not None and h0.shape != (Bsz, D, N):
        raise ValueError(f"h0 must be {(Bsz, D, N)}, got {tuple(h0.shape)}")
    if not (x.dtype == dt.dtype == B.dtype == C.dtype):
        raise TypeError(f"x, dt, B and C must share one dtype, got "
                        f"{x.dtype}, {dt.dtype}, {B.dtype}, {C.dtype}")
    tensors = [x, dt, B, C, A] + ([h0] if h0 is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"devices differ: {[str(t.device) for t in tensors]}")
    if x.device.type == "cpu":
        return ref.ssm_scan(x, dt, B, C, A, h0, return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"no ssm_scan kernel for device {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"the ssm_scan kernel takes float32 or bfloat16 "
                        f"x, dt, B, C, not {x.dtype}")
    if A.dtype != torch.float32 or (h0 is not None
                                    and h0.dtype != torch.float32):
        raise TypeError("the ssm_scan kernel takes float32 A and h0")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the ssm_scan kernel takes contiguous tensors")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"the ssm_scan kernel takes 1 <= N <= {MAX_STATE} "
                         f"states per channel, got N = {N}")
    if Bsz > _MAX_BATCH or max(S, D) > _INT_MAX:
        raise ValueError(f"shape {(Bsz, S, D)} exceeds the kernel's grid")
    y = torch.empty_like(x)
    h_final = torch.empty((Bsz, D, N), dtype=torch.float32, device=x.device)
    if Bsz and D:
        lib = _build.library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), h0.data_ptr() if h0 is not None else None,
            y.data_ptr(), h_final.data_ptr(), Bsz, S, D, N,
            x.device.index, stream)
        _build.check(err, "ssm_scan kernel launch")
        with _launch_lock:
            ssm_scan.launches += 1
    return (y, h_final) if return_state else y


ssm_scan.launches = 0

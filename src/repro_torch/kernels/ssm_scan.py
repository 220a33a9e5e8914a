"""The hand-written CUDA selective-scan kernels (``csrc/ssm_scan.cu``, and
its backward ``csrc/ssm_scan_bwd.cu``), their wrappers and the autograd
Function :class:`SSMScan` over them.

Port of ``repro/kernels/ssm_scan.py::ssm_scan``, extended with what
``repro/models/ssm.py::selective_scan`` carries: an initial state ``h0`` and
the final state.  The JAX package has no backward kernel (it differentiates
its jnp scan); :func:`ssm_scan_backward` computes that same gradient.  The
sources' headers say how the TPU kernel translates and what bounds each
kernel on the H100.

For tensors on the CPU each wrapper returns its plain version
(:func:`repro_torch.kernels.ref.ssm_scan`, :func:`~repro_torch.kernels.ref.
ssm_scan_backward`).  For CUDA tensors it launches its kernel or raises; it
never falls back.  ``ssm_scan.launches`` and ``ssm_scan_backward.launches``
count the kernels' launches, so a run can show that its work went through
them.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from . import _build, operator_route, ref, refuse_grad

_ENTRY = {torch.float32: "repro_ssm_scan_f32",
          torch.bfloat16: "repro_ssm_scan_bf16"}
_BWD_ENTRY = "repro_ssm_scan_bwd_f32"
MAX_STATE = 32             # N: one channel's states share one warp
_INT_MAX = 2 ** 31 - 1
_MAX_BATCH = 65535         # the batch is the grid's y dimension
_launch_lock = threading.Lock()   # guards the launch counts across workers


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *,
             return_state: bool = False, return_states: bool = False):
    """Selective scan of ``x, dt (Bsz, S, D)``, ``B, C (Bsz, S, N)`` with
    ``A (D, N)`` from ``h0 (Bsz, D, N)`` (zeros when None).

    Returns ``y (Bsz, S, D)`` in ``x.dtype`` and, with ``return_state``,
    also the float32 final state ``(Bsz, D, N)`` (``h0`` when ``S == 0``);
    with ``return_states`` ``(y, h_final, states)``: ``states (Bsz,
    ceil(S / 16), D, N)``, float32, the state before every 16 steps, which
    :func:`ssm_scan_backward` starts its chunks from.  On the card ``x, dt,
    B, C`` are float32 or bfloat16, all of one dtype, ``A`` and ``h0``
    float32, every tensor contiguous, and ``1 <= N <= 32``.
    It raises when a gradient is asked of it, on any device:
    :class:`SSMScan` carries one.
    """
    refuse_grad("ssm_scan", x, dt, B, C, A, h0,
                remedy="call repro_torch.kernels.ops.ssm_scan, whose "
                       "autograd Function (SSMScan) gives one")
    _check(x, dt, B, C, A, h0)
    Bsz, S, D = x.shape
    N = A.shape[1]
    if x.device.type == "cpu":
        return ref.ssm_scan(x, dt, B, C, A, h0, return_state=return_state,
                            return_states=return_states)
    if x.dtype not in _ENTRY:
        raise TypeError(f"the ssm_scan kernel takes float32 or bfloat16 "
                        f"x, dt, B, C, not {x.dtype}")
    _check_card(x, dt, B, C, A, h0)
    y = torch.empty_like(x)
    h_final = torch.empty((Bsz, D, N), dtype=torch.float32, device=x.device)
    states = (torch.empty((Bsz, -(-S // ref.STATE_CHUNK), D, N),
                          dtype=torch.float32, device=x.device)
              if return_states else None)
    if Bsz and D:
        lib = _build.library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), _ptr(h0), y.data_ptr(), h_final.data_ptr(),
            _ptr(states), Bsz, S, D, N, x.device.index, stream)
        _build.check(err, "ssm_scan kernel launch")
        with _launch_lock:
            ssm_scan.launches += 1
    if return_states:
        return y, h_final, states
    return (y, h_final) if return_state else y


ssm_scan.launches = 0


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(x, dt, B, C, A, h0) -> None:
    """The shapes, dtypes and devices both wrappers take, on any device."""
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no ssm_scan kernel for device {x.device}")


def _check_card(*tensors) -> None:
    """What the kernels take on the card beyond :func:`_check`: float32
    ``A``, states and upstream gradients, contiguous tensors, ``1 <= N <=
    32``, a grid that fits.  ``tensors`` are ``x, dt, B, C, A`` and then
    the states and gradients, ``None`` for one not given."""
    x, A = tensors[0], tensors[4]
    present = [t for t in tensors if t is not None]
    if A.dtype != torch.float32 or any(t.dtype != torch.float32
                                       for t in present[5:]):
        raise TypeError("the ssm_scan kernels take float32 A, states and "
                        "gradients")
    if not all(t.is_contiguous() for t in present):
        raise ValueError("the ssm_scan kernels take contiguous tensors")
    Bsz, S, D = x.shape
    N = A.shape[1]
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"the ssm_scan kernels take 1 <= N <= {MAX_STATE} "
                         f"states per channel, got N = {N}")
    if Bsz > _MAX_BATCH or max(S, D) > _INT_MAX:
        raise ValueError(f"shape {(Bsz, S, D)} exceeds the kernel's grid")


def ssm_scan_backward(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, A: torch.Tensor,
                      h0: Optional[torch.Tensor], dy: torch.Tensor,
                      dh_final: Optional[torch.Tensor] = None, *,
                      states: Optional[torch.Tensor] = None):
    """Gradients ``(dx, ddt, dB, dC, dA, dh0)`` of
    ``ssm_scan(x, dt, B, C, A, h0, return_state=True)`` for the upstream
    gradients ``dy (Bsz, S, D)`` of ``y`` and ``dh_final (Bsz, D, N)`` of
    the final state (zeros when None): the function of
    :func:`repro_torch.kernels.ref.ssm_scan_backward`, all float32.

    ``states`` are the forward's, as ``ssm_scan(..., return_states=True)``
    gives them (``SSMScan`` keeps them); without them one launch of the
    forward kernel (counted in ``ssm_scan.launches``) makes them first.
    On the card every tensor is float32 and contiguous and ``1 <= N <=
    32`` (the model widens the scan's inputs to float32).  The kernel
    writes ``dB`` and ``dC`` as one partial sum per block of channels and
    ``dA`` per batch row, and sums them in a second kernel in a fixed
    order: no float atomics, so two launches give the same bits.
    """
    _check(x, dt, B, C, A, h0)
    Bsz, S, D = x.shape
    N = A.shape[1]
    if dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)}, got "
                         f"{tuple(dy.shape)}")
    if dh_final is not None and dh_final.shape != (Bsz, D, N):
        raise ValueError(f"dh_final must be {(Bsz, D, N)}, got "
                         f"{tuple(dh_final.shape)}")
    if any(t is not None and t.device != x.device for t in (dy, dh_final)):
        raise ValueError(f"devices differ: x on {x.device}, dy on "
                         f"{dy.device}")
    if states is not None:
        want = (Bsz, -(-S // ref.STATE_CHUNK), D, N)
        if states.shape != want or states.device != x.device:
            raise ValueError(f"states must be {want} on {x.device}, got "
                             f"{tuple(states.shape)} on {states.device}")
    if x.device.type == "cpu":
        return ref.ssm_scan_backward(x, dt, B, C, A, h0, dy, dh_final,
                                     states=states)
    if x.dtype != torch.float32:
        raise TypeError(f"the ssm_scan backward kernel takes float32 x, dt, "
                        f"B, C, not {x.dtype}")
    _check_card(x, dt, B, C, A, h0, dh_final, dy, states)
    if states is None:
        states = ssm_scan(x, dt, B, C, A, h0, return_states=True)[2]
    dev = x.device
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dh0 = torch.empty((Bsz, D, N), dtype=torch.float32, device=dev)
    if not (Bsz and D):
        return (dx, ddt, B.new_zeros(B.shape), C.new_zeros(C.shape),
                A.new_zeros(A.shape), dh0)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.empty_like(A)
    dB_part = torch.empty((-(-D // _bwd_channels(N)), Bsz, S, N),
                          dtype=torch.float32, device=dev)
    dC_part = torch.empty_like(dB_part)
    dA_part = torch.empty_like(dh0)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, _BWD_ENTRY)(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), states.data_ptr(), dy.data_ptr(), _ptr(dh_final),
        dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dA.data_ptr(), dh0.data_ptr(), dB_part.data_ptr(),
        dC_part.data_ptr(), dA_part.data_ptr(), Bsz, S, D, N, dev.index,
        stream)
    _build.check(err, "ssm_scan backward kernel launch")
    with _launch_lock:
        ssm_scan_backward.launches += 1
    return dx, ddt, dB, dC, dA, dh0


ssm_scan_backward.launches = 0


def _bwd_channels(N: int) -> int:
    """Channels of one block of the backward kernel at N states
    (csrc/ssm_scan_bwd.cu's CPB): the kernel writes one dB and dC partial
    per block."""
    return 32 if N > 16 else 64


class SSMScan(torch.autograd.Function):
    """The selective scan with a gradient: ``apply(x, dt, B, C, A, h0)``
    returns ``(y, h_final)``.  The forward is :func:`ssm_scan` (its plain
    version for CPU tensors) exactly as serving calls it, the backward
    :func:`ssm_scan_backward` in float32; gradients to bf16 inputs are cast
    back.  It saves its inputs and the forward's states (the state before
    every 16 steps: 134 MB at 2 × 2048 × 8192 × 16), from which the
    backward kernel starts its chunks; under activation checkpointing the
    forward runs again in the recompute, so each forward launch counts
    there too and the states live from the recompute to the backward.
    While a count runs, or for fake tensors, both go through the operators
    ``repro_torch::ssm_scan`` and ``repro_torch::ssm_scan_backward``
    (``kernels/operators.py``), which call the same wrappers.
    """

    @staticmethod
    def forward(ctx, x, dt, B, C, A, h0):
        op = operator_route(x, dt, B, C, A, h0)
        y, h_final, states = (
            op.ssm_scan(x, dt, B, C, A, h0, True) if op is not None
            else ssm_scan(x, dt, B, C, A, h0, return_states=True))
        ctx.save_for_backward(x, dt, B, C, A, h0, states)
        return y, h_final

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dh_final):
        x, dt, B, C, A, h0, states = ctx.saved_tensors
        args = (*(t.float().contiguous() for t in (x, dt, B, C)), A, h0,
                dy.float().contiguous(), dh_final.contiguous())
        op = operator_route(x, dy)
        dx, ddt, dB, dC, dA, dh0 = (
            op.ssm_scan_backward(*args, states) if op is not None
            else ssm_scan_backward(*args, states=states))
        return (dx.to(x.dtype), ddt.to(dt.dtype), dB.to(B.dtype),
                dC.to(C.dtype), dA, None if h0 is None else dh0)

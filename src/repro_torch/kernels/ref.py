"""Plain PyTorch versions of the port's kernels (the allclose targets).

Port of ``repro/kernels/ref.py``.  Each function here is the kernel's plain
version: the kernel wrapper runs it for tensors on the CPU, and
``chip_smoke.py`` and the GPU tests hold the kernel against it on the card.
"""
from __future__ import annotations

from typing import Optional

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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """Softmax attention of ``q (B, H, Sq, D)`` over ``k, v (B, KH, Sk, D)``,
    returned as ``(B, H, Sq, D)`` in ``q.dtype``.

    K/V are repeated to ``H`` heads (query head ``h`` reads kv head
    ``h // (H // KH)``); scores, softmax and ``p @ v`` are float32, with
    scale ``D ** -0.5``.  ``causal`` masks key ``j`` from query ``i`` unless
    ``j <= i`` on absolute indices from 0 (top-left, also when Sq != Sk).
    Port of ``repro/kernels/ref.py::attention``.  Like :func:`matmul` it
    refuses to run on the card while TF32 is allowed.
    """
    if q.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "ref.attention needs torch.backends.cuda.matmul.allow_tf32 = "
            "False")
    H, Sq, D = q.shape[1], q.shape[2], q.shape[3]
    KH, Sk = k.shape[1], k.shape[2]
    if H != KH:
        k = torch.repeat_interleave(k, H // KH, dim=1)
        v = torch.repeat_interleave(v, H // KH, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (D ** -0.5)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *,
             return_state: bool = False):
    """Step-by-step selective scan in float32.

    ``x, dt (Bsz, S, D)``, ``B, C (Bsz, S, N)``, ``A (D, N)``, optional
    ``h0 (Bsz, D, N)`` (zeros when None).  Each step does
    ``h = exp(dt_t * A) * h + (dt_t * x_t) ⊗ B_t`` and ``y_t = h · C_t``.
    Returns ``y (Bsz, S, D)`` in ``x.dtype``, and with ``return_state``
    also the float32 state after the last step (``h0`` when ``S == 0``).

    Port of ``repro/kernels/ref.py::ssm_scan``, extended with the initial
    and final state that ``repro/models/ssm.py::selective_scan`` carries.
    """
    Bsz, S, D = x.shape
    N = A.shape[-1]
    xf, dtf, Bf, Cf, Af = (t.float() for t in (x, dt, B, C, A))
    h = (torch.zeros((Bsz, D, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float().clone())
    ys = torch.empty((Bsz, S, D), dtype=torch.float32, device=x.device)
    for t in range(S):
        da = torch.exp(dtf[:, t, :, None] * Af[None])            # (Bsz, D, N)
        h = da * h + (dtf[:, t] * xf[:, t])[:, :, None] * Bf[:, t, None, :]
        ys[:, t] = (h * Cf[:, t, None, :]).sum(-1)   # no TF32 product here
    y = ys.to(x.dtype)
    return (y, h) if return_state else y

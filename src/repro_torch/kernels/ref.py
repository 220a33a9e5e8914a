"""Plain PyTorch versions of the port's kernels (the allclose targets).

Port of ``repro/kernels/ref.py``.  Each function here is the kernel's plain
version: the kernel wrapper runs it for tensors on the CPU, and
``chip_smoke.py`` and the GPU tests hold the kernel against it on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

#: steps whose decays, inputs and outputs ssm_scan forms at once, and
#: whose states ssm_scan_backward recomputes at once
SCAN_CHUNK = 64
#: steps between two states that ssm_scan keeps for the backward (the
#: kernels' too: csrc/ssm_scan.cu's SCH, csrc/ssm_scan_bwd.cu's CH)
STATE_CHUNK = 16


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
              causal: bool = True, return_lse: bool = False):
    """Softmax attention of ``q (B, H, Sq, D)`` over ``k, v (B, KH, Sk, D)``,
    returned as ``(B, H, Sq, D)`` in ``q.dtype``.

    K/V are repeated to ``H`` heads (query head ``h`` reads kv head
    ``h // (H // KH)``); scores, softmax and ``p @ v`` are float32, with
    scale ``D ** -0.5``.  ``causal`` masks key ``j`` from query ``i`` unless
    ``j <= i`` on absolute indices from 0 (top-left, also when Sq != Sk).
    Port of ``repro/kernels/ref.py::attention``.  Like :func:`matmul` it
    refuses to run on the card while TF32 is allowed.

    With ``return_lse`` it returns ``(out, lse)``: ``lse (B, H, Sq)``, each
    row's float32 log-sum-exp of its masked scaled scores (natural log;
    ``-inf`` for a row with no key, ``Sk == 0``), as the kernels write it
    for the backward.
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
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *,
             return_state: bool = False, return_states: bool = False):
    """Step-by-step selective scan in float32.

    ``x, dt (Bsz, S, D)``, ``B, C (Bsz, S, N)``, ``A (D, N)``, optional
    ``h0 (Bsz, D, N)`` (zeros when None).  Each step does
    ``h = exp(dt_t * A) * h + (dt_t * x_t) ⊗ B_t`` and ``y_t = h · C_t``.
    Returns ``y (Bsz, S, D)`` in ``x.dtype``, and with ``return_state``
    also the float32 state after the last step (``h0`` when ``S == 0``);
    with ``return_states`` ``(y, h_final, states)``, where ``states
    (Bsz, ceil(S / STATE_CHUNK), D, N)`` holds the state before every
    ``STATE_CHUNK`` steps, as :func:`ssm_scan_backward` takes them.
    Only the recurrence runs step by step: ``exp(dt_t * A)``, the inputs
    ``(dt_t * x_t) ⊗ B_t`` and the products with ``C_t`` are formed for
    ``SCAN_CHUNK`` steps at a time, which leaves two ops a step (and two
    autograd nodes: the plain training step differentiates this loop).

    Port of ``repro/kernels/ref.py::ssm_scan``, extended with the initial
    and final state that ``repro/models/ssm.py::selective_scan`` carries.
    """
    Bsz, S, D = x.shape
    N = A.shape[-1]
    xf, dtf, Bf, Cf, Af = (t.float() for t in (x, dt, B, C, A))
    h = (torch.zeros((Bsz, D, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float().clone())
    ys = [torch.empty((Bsz, 0, D), dtype=torch.float32, device=x.device)]
    states = [torch.empty((Bsz, 0, D, N), dtype=torch.float32,
                          device=x.device)]
    for t0 in range(0, S, SCAN_CHUNK):
        t1 = min(t0 + SCAN_CHUNK, S)
        da = torch.exp(dtf[:, t0:t1, :, None] * Af)          # (Bsz, L, D, N)
        u = (dtf[:, t0:t1] * xf[:, t0:t1])[..., None] * Bf[:, t0:t1, None, :]
        hs = []
        for i in range(t1 - t0):
            if return_states and (t0 + i) % STATE_CHUNK == 0:
                states.append(h[:, None])
            h = da[:, i] * h + u[:, i]
            hs.append(h)
        # elementwise products and a sum: no TF32 product here
        ys.append((torch.stack(hs, 1) * Cf[:, t0:t1, None, :]).sum(-1))
    y = torch.cat(ys, 1).to(x.dtype)
    if return_states:
        return y, h, torch.cat(states, 1)
    return (y, h) if return_state else y


def ssm_scan_backward(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, A: torch.Tensor,
                      h0: Optional[torch.Tensor], dy: torch.Tensor,
                      dh_final: Optional[torch.Tensor] = None, *,
                      states: Optional[torch.Tensor] = None):
    """Gradients of :func:`ssm_scan` in float32 torch ops: for the upstream
    gradients ``dy (Bsz, S, D)`` of ``y`` and ``dh_final (Bsz, D, N)`` of the
    final state (zeros when None), returns ``(dx, ddt, dB, dC, dA, dh0)``,
    all float32, shaped as ``x, dt, B, C, A`` and ``(Bsz, D, N)``.

    With ``a_t = exp(dt_t A)``, ``h_t = a_t h_{t-1} + dt_t x_t B_t`` and
    ``y_t = h_t · C_t``, the reverse recurrence runs from ``g = dh_final``:
    ``g_t = dy_t C_t + a_{t+1} g_{t+1}``, and

    - ``dC_t = Σ_d h_t dy_t``, ``dB_t = Σ_d g_t dt_t x_t``;
    - ``dx_t = dt_t Σ_n g_t B_t``;
    - ``ddt_t = Σ_n g_t (A a_t h_{t-1} + x_t B_t)``;
    - ``dA = Σ_{b,t} g_t dt_t a_t h_{t-1}``, ``dh0 = a_0 g_0``.

    ``h`` is recomputed ``SCAN_CHUNK`` steps at a time from the states at
    the chunks' starts: a whole ``h`` would be 2.1 GB at 2 × 2048 × 8192 ×
    16.  They are every ``SCAN_CHUNK // STATE_CHUNK``-th of ``states``, as
    :func:`ssm_scan` returns them (the forward of a training step keeps
    them); without ``states`` a run of :func:`ssm_scan` gives them.  The
    JAX package differentiates its scan with XLA; this is the same
    function, and the backward kernel's plain version.
    """
    Bsz, S, D = x.shape
    N = A.shape[-1]
    if states is None:
        states = ssm_scan(x, dt, B, C, A, h0, return_states=True)[2]
    xf, dtf, Bf, Cf, Af, dyf = (t.float() for t in (x, dt, B, C, A, dy))
    dev = x.device
    starts = list(range(0, S, SCAN_CHUNK))
    bounds = states[:, ::SCAN_CHUNK // STATE_CHUNK].unbind(1)
    g_next = (torch.zeros((Bsz, D, N), dtype=torch.float32, device=dev)
              if dh_final is None else dh_final.float().clone())
    dx = torch.empty((Bsz, S, D), dtype=torch.float32, device=dev)
    ddt, dB, dC = torch.empty_like(dx), torch.empty_like(Bf), \
        torch.empty_like(Cf)
    dA = torch.zeros((D, N), dtype=torch.float32, device=dev)
    for t0, h in zip(reversed(starts), reversed(bounds)):
        t1 = min(t0 + SCAN_CHUNK, S)
        L = t1 - t0
        dtc, xc, dyc = dtf[:, t0:t1], xf[:, t0:t1], dyf[:, t0:t1]
        Bc, Cc = Bf[:, t0:t1, None, :], Cf[:, t0:t1, None, :]
        a = torch.exp(dtc[..., None] * Af)                   # (Bsz, L, D, N)
        dtx = dtc * xc
        u = dtx[..., None] * Bc
        hs = torch.empty((Bsz, L + 1, D, N), dtype=torch.float32, device=dev)
        hs[:, 0] = h
        for i in range(L):
            hs[:, i + 1] = a[:, i] * hs[:, i] + u[:, i]
        del u
        dyC = dyc[..., None] * Cc
        gs = torch.empty_like(a)
        for i in reversed(range(L)):
            gs[:, i] = dyC[:, i] + g_next
            g_next = a[:, i] * gs[:, i]
        del dyC
        # elementwise products and sums: no TF32 product here
        dC[:, t0:t1] = (hs[:, 1:] * dyc[..., None]).sum(2)
        dB[:, t0:t1] = (gs * dtx[..., None]).sum(2)
        gB = (gs * Bc).sum(-1)                               # (Bsz, L, D)
        dx[:, t0:t1] = dtc * gB
        q = gs * a * hs[:, :L]
        ddt[:, t0:t1] = (q * Af).sum(-1) + xc * gB
        dA += (q * dtc[..., None]).sum((0, 1))
        del a, gs, hs, q
    return dx, ddt, dB, dC, dA, g_next

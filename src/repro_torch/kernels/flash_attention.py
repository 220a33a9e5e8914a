"""The hand-written CUDA flash-attention kernels, forward and backward, and
their wrappers.

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

The gradient (:class:`FlashAttention`) has a kernel on each route too,
:func:`flash_attention_backward`: ``csrc/flash_attention_bwd_wgmma.cu`` for
the calls whose forward takes the wgmma route (and whose ``out`` and
``dout`` are 16-byte aligned as well), ``csrc/flash_attention_bwd.cu`` for
the rest.  Both read the forward's row log-sum-exp, which the forward
kernels write when asked (``return_lse``); for CPU tensors the backward is
:func:`attention_backward`, the plain version, given the same ``lse``.
"""
from __future__ import annotations

import threading

import torch

from . import _build, operator_route, ref, refuse_grad

_ENTRY = {("simt", torch.float32): "repro_flash_attention_f32",
          ("simt", torch.bfloat16): "repro_flash_attention_bf16",
          ("wgmma", torch.bfloat16): "repro_flash_attention_bf16_wgmma"}
_BWD_ENTRY = {("simt", torch.float32): "repro_flash_attention_bwd_f32",
              ("simt", torch.bfloat16): "repro_flash_attention_bwd_bf16",
              ("wgmma", torch.bfloat16):
                  "repro_flash_attention_bwd_bf16_wgmma"}
ROUTES = ("wgmma", "simt")
MAX_HEAD_DIM = 128
_INT_MAX = 2 ** 31 - 1
_MAX_GRID_YZ = 65535       # heads and batch are the grid's y and z
_launch_lock = threading.Lock()   # guards the wrappers' launch counts


def route(dtype: torch.dtype, D: int, *, aligned: bool = True) -> str:
    """The kernel that takes head dim ``1 <= D <= 128`` in ``dtype`` on the
    card, forward or backward; ``aligned``: every tensor the kernel reads
    (q, k and v; and out and dout for the backward) starts on a 16-byte
    boundary."""
    return ("wgmma" if dtype == torch.bfloat16 and D % 8 == 0 and aligned
            else "simt")


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raises unless q, k and v are one attention's inputs."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, Sq, D) and k, v one (B, KH, Sk, "
                         f"D) shape, got {tuple(q.shape)}, {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    B, H, _, D = q.shape
    KH = k.shape[1]
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


def _check_card(name: str, *tensors) -> None:
    """Raises unless the kernel ``name`` takes ``tensors`` (q first) on the
    card."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the {name} kernel takes float32 or bfloat16, not "
                        f"{q.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"the {name} kernel takes contiguous tensors")
    B, H, Sq, D = q.shape
    Sk = tensors[1].shape[2]
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"the {name} kernel takes head dims 1 <= D <= "
                         f"{MAX_HEAD_DIM}, got D = {D}")
    if max(B, H) > _MAX_GRID_YZ or max(Sq, Sk) > _INT_MAX:
        raise ValueError(f"shape {(B, H, Sq, Sk)} exceeds the kernel's grid")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, return_lse: bool = False):
    """Attention of ``q (B, H, Sq, D)`` over ``k, v (B, KH, Sk, D)`` with
    ``H % KH == 0``; returns ``(B, H, Sq, D)`` in ``q.dtype``, and with
    ``return_lse`` also each row's float32 log-sum-exp ``(B, H, Sq)`` of
    its masked scaled scores (natural log, ``-inf`` when ``Sk == 0``),
    which :func:`flash_attention_backward` reads.

    On the card q, k and v are float32 or bfloat16, all of one dtype,
    contiguous, with ``1 <= D <= 128``.  ``Sk == 0`` gives zeros.  It
    raises when a gradient is asked of it (grad mode on and an input that
    requires grad), on any device: :class:`FlashAttention` carries one.
    """
    refuse_grad("flash_attention", q, k, v,
                remedy="call repro_torch.kernels.ops.flash_attention, whose "
                       "autograd Function (FlashAttention) gives one")
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, return_lse=return_lse)
    _check_card("flash_attention", q, k, v)
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    path = route(q.dtype, D, aligned=_aligned(q, k, v))
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B and Sq:
        lib = _build.library()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, _ENTRY[path, q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, H, KH, Sq, Sk, D, int(causal), q.device.index, stream)
        _build.check(err, f"flash_attention kernel launch ({path})")
        with _launch_lock:
            flash_attention.launches += 1
            flash_attention.route_launches[path] += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool):
    """``(dq, dk, dv)`` of ``out = flash_attention(q, k, v)`` for the
    upstream gradient ``dout``, each in its input's dtype, given the
    forward's ``out`` and row log-sum-exp ``lse`` (``flash_attention(...,
    return_lse=True)``).

    For CPU tensors it is :func:`attention_backward`, the plain version,
    given ``lse``.  For CUDA tensors it launches the backward kernel of
    :func:`route` (the pre-pass ``delta = rowsum(dO ∘ O)``, then the dK/dV
    pass and the dQ pass; one launch in the counts) or raises; it never
    falls back.  On the card q, k, v, out and dout share a dtype, float32
    or bfloat16, are contiguous, and ``1 <= D <= 128``; lse is a contiguous
    float32 ``(B, H, Sq)``.  With ``Sq == 0`` or ``Sk == 0`` the gradients
    are zeros and nothing launches.  ``flash_attention_backward.launches``
    and ``.route_launches`` count launches as the forward's counts do.
    """
    _check(q, k, v)
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dout must be shaped as q "
                         f"{tuple(q.shape)}, got {tuple(out.shape)} and "
                         f"{tuple(dout.shape)}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(B, H, Sq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if not (out.dtype == dout.dtype == q.dtype):
        raise TypeError(f"out and dout must be {q.dtype}, got {out.dtype} "
                        f"and {dout.dtype}")
    if not all(t.device == q.device for t in (out, dout, lse)):
        raise ValueError("out, dout and lse must lie on q's device")
    if q.device.type == "cpu":
        return attention_backward(q, k, v, out, dout, causal=causal, lse=lse)
    _check_card("flash_attention_backward", q, k, v, out, dout, lse)
    path = route(q.dtype, D, aligned=_aligned(q, k, v, out, dout))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not (B and Sq and Sk):
        for t in (dq, dk, dv):
            t.zero_()
        return dq, dk, dv
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, _BWD_ENTRY[path, q.dtype])(
        *(t.data_ptr() for t in (q, k, v, out, dout, lse, dq, dk, dv, delta)),
        B, H, KH, Sq, Sk, D, int(causal), q.device.index, stream)
    _build.check(err, f"flash_attention_backward kernel launch ({path})")
    with _launch_lock:
        flash_attention_backward.launches += 1
        flash_attention_backward.route_launches[path] += 1
    return dq, dk, dv


flash_attention_backward.launches = 0
flash_attention_backward.route_launches = dict.fromkeys(ROUTES, 0)


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, dout: torch.Tensor, *,
                       causal: bool, lse: torch.Tensor):
    """``(dq, dk, dv)`` of ``out = attention(q, k, v)`` for the upstream
    gradient ``dout``, in explicit torch ops, each in its input's dtype: the
    backward kernels' plain version, given the forward's row log-sum-exp
    ``lse (B, H, Sq)`` as they are.

    One kv head at a time (its ``G = H / KH`` query heads folded into the
    rows, so ``dk`` and ``dv`` sum over them in the products), in float32:
    ``S = scale · Q Kᵀ`` with the top-left causal mask ``kpos <= qpos`` from
    0, ``P = exp(S − lse)`` (the softmax, as the kernels re-form it),
    ``dV = Pᵀ dO``, ``dP = dO Vᵀ``,
    ``dS = P ∘ (dP − rowsum(dO ∘ O))``, ``dQ = scale · dS K``,
    ``dK = scale · dSᵀ Q``.  In bf16, P is rounded to bf16 where it meets
    V's gradient, as the wgmma forward rounds it before ``P V``.  A kv
    head's S, P, dP and dS are float32 ``(B, G·Sq, Sk)``: at qwen2-7b's
    2 × 2048 tokens, 0.23 GB each instead of the 0.94 GB of all heads.
    """
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    scale = D ** -0.5
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    visible = None
    if causal:
        qpos = torch.arange(G * Sq, device=q.device) % Sq
        visible = torch.arange(Sk, device=q.device)[None, :] <= qpos[:, None]
    for j in range(KH):
        heads = slice(j * G, (j + 1) * G)
        qj, doj, oj = (t[:, heads].reshape(B, G * Sq, D).float()
                       for t in (q, dout, out))
        kj, vj = k[:, j].float(), v[:, j].float()
        s = torch.matmul(qj, kj.transpose(1, 2)) * scale
        if visible is not None:
            s = torch.where(visible, s, -1e30)
        p = torch.exp(s - lse[:, heads].reshape(B, G * Sq, 1))
        del s
        p_v = p.to(torch.bfloat16).float() if q.dtype == torch.bfloat16 \
            else p
        dv[:, j] = torch.matmul(p_v.transpose(1, 2), doj)
        del p_v
        ds = torch.matmul(doj, vj.transpose(1, 2))
        ds.sub_((doj * oj).sum(dim=-1, keepdim=True)).mul_(p)
        del p
        dq[:, heads] = (torch.matmul(ds, kj) * scale).view(B, G, Sq, D)
        dk[:, j] = torch.matmul(ds.transpose(1, 2), qj) * scale
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: the forward is the kernel (its
    plain version for CPU tensors) as serving calls it, asked also for each
    row's log-sum-exp; the backward is :func:`flash_attention_backward`,
    the backward kernel on the forward's route (:func:`attention_backward`
    for CPU tensors).  The JAX package's flash kernel has no backward; its
    training differentiates the attention through XLA, and this is the
    same gradient.  It saves q, k, v, the output and the lse; under
    activation checkpointing the forward runs again in the recompute, so
    each launch counts there too.  While a count runs, or for fake tensors,
    both go through the operators ``repro_torch::flash_attention`` and
    ``repro_torch::flash_attention_backward`` (``kernels/operators.py``),
    which call the same wrappers."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        op = operator_route(q, k, v)
        if op is not None:
            out, lse = op.flash_attention(q, k, v, causal, True)
        else:
            out, lse = flash_attention(q, k, v, causal=causal,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        op = operator_route(q, k, v, dout)
        dq, dk, dv = (
            op.flash_attention_backward(q, k, v, out, dout, lse, ctx.causal)
            if op is not None
            else flash_attention_backward(q, k, v, out, dout, lse,
                                          causal=ctx.causal))
        return dq, dk, dv, None

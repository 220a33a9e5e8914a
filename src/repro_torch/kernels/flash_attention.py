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

from . import _build, operator_route, ref, refuse_grad

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
    contiguous, with ``1 <= D <= 128``.  ``Sk == 0`` gives zeros.  It
    raises when a gradient is asked of it (grad mode on and an input that
    requires grad), on any device: :class:`FlashAttention` carries one.
    """
    refuse_grad("flash_attention", q, k, v,
                remedy="call repro_torch.kernels.ops.flash_attention, whose "
                       "autograd Function (FlashAttention) gives one")
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


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, dout: torch.Tensor, *,
                       causal: bool):
    """``(dq, dk, dv)`` of ``out = attention(q, k, v)`` for the upstream
    gradient ``dout``, in explicit torch ops, each in its input's dtype.

    One kv head at a time (its ``G = H / KH`` query heads folded into the
    rows, so ``dk`` and ``dv`` sum over them in the products), in float32:
    ``S = scale · Q Kᵀ`` with the top-left causal mask ``kpos <= qpos`` from
    0, ``P = softmax(S)``, ``dV = Pᵀ dO``, ``dP = dO Vᵀ``,
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
        p = torch.softmax(s, dim=-1)
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
    plain version for CPU tensors) exactly as serving calls it, the
    backward :func:`attention_backward`.  The JAX package's flash kernel
    has no backward kernel, so neither has this.  It saves q, k, v and the
    output; under activation checkpointing the forward runs again in the
    recompute, so each launch counts there too.  While a count runs, or
    for fake tensors, the forward goes through the operator
    ``repro_torch::flash_attention`` (``kernels/operators.py``), which calls
    the same wrapper; the backward's torch ops are counted as they run."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        op = operator_route(q, k, v)
        out = (op.flash_attention(q, k, v, causal) if op is not None
               else flash_attention(q, k, v, causal=causal))
        ctx.save_for_backward(q, k, v, out)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, dout.contiguous(),
                                        causal=ctx.causal)
        return dq, dk, dv, None

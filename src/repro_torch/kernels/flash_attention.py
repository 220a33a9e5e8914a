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
kernel on the H100.  The wgmma kernel is persistent: it walks every
(128-row query tile, head, batch) of the call in the order of
:func:`forward_schedule` (heaviest first), which the wrapper hands over as
a device tensor cached per shape and device (:func:`forward_units`).

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
Each runs its dK/dV and dQ units in one launch, in the order of
:func:`backward_schedule` (heaviest first), which the wrapper hands over as
a device tensor cached per shape and device (:func:`backward_units`).
"""
from __future__ import annotations

import ctypes
import math
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
FWD_ROWS = 128             # the queries of a wgmma forward unit, and the
FWD_KEYS = 128             # keys of one of its kv tiles
_launch_lock = threading.Lock()   # guards the wrappers' launch counts
# the rows of a backward unit on each route: the keys of a dK/dV unit, the
# queries of a dQ unit
BWD_ROWS = {"wgmma": 128, "simt": 64}
BWD_STEP = 64              # queries (dK/dV) or keys (dQ) of a unit's step
DKDV, DQ = 0, 1            # the kinds of backward unit
# products a step of each kind: S^T, dP^T, dV, dK; S, dP, dQ
BWD_STEP_COST = {DKDV: 4, DQ: 3}
_units_cache: dict = {}
_units_lock = threading.Lock()


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
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr()]
        if path == "wgmma":
            units = forward_units(B, H, Sq, Sk, causal, q.device)
            ptrs += [units.data_ptr(), units.shape[0]]
        err = getattr(lib, _ENTRY[path, q.dtype])(
            *ptrs, B, H, KH, Sq, Sk, D, int(causal), q.device.index, stream)
        _build.check(err, f"flash_attention kernel launch ({path})")
        with _launch_lock:
            flash_attention.launches += 1
            flash_attention.route_launches[path] += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)


def forward_schedule(B: int, H: int, Sq: int, Sk: int,
                     causal: bool) -> list:
    """Every unit of the wgmma forward kernel for these sizes, as ``(tile,
    head, batch, cost)``, heaviest first.

    A unit owns the :data:`FWD_ROWS` queries of tile ``t`` (rows
    ``128·t`` on) of query head ``head`` and walks the
    :data:`FWD_KEYS`-key tiles up to its last row's diagonal (all of them
    when not causal); ``cost`` is that count of kv tiles (0 when ``Sk ==
    0``: the unit writes zeros).  Units of equal cost keep the order batch,
    head, tile, so the list is a pure function of its arguments.  GQA
    changes no cost, so the kv heads are not an argument.
    """
    units = []
    for b in range(B):
        for h in range(H):
            for t in range(math.ceil(Sq / FWD_ROWS)):
                last = min(FWD_ROWS * (t + 1), Sq)
                end = min(Sk, last) if causal else Sk
                units.append((t, h, b, math.ceil(end / FWD_KEYS)))
    units.sort(key=lambda u: (-u[3], u[2], u[1], u[0]))
    return units


def forward_units(B: int, H: int, Sq: int, Sk: int, causal: bool,
                  device) -> torch.Tensor:
    """:func:`forward_schedule`'s units as an int32 ``(n, 3)`` tensor of
    ``(tile, head, batch)`` on ``device``, which the wgmma forward kernel
    walks (its blocks in snake order, ``csrc/flash_attention_wgmma.cu``).
    Made once per shape and device and kept, as :func:`backward_units`
    is."""
    key = ("forward", B, H, Sq, Sk, bool(causal), torch.device(device))
    with _units_lock:
        units = _units_cache.get(key)
        if units is None:
            rows = [u[:3] for u in forward_schedule(B, H, Sq, Sk, causal)]
            units = torch.tensor(rows, dtype=torch.int32).reshape(
                -1, 3).to(key[-1])
            _units_cache[key] = units
    return units


def backward_schedule(B: int, H: int, KH: int, Sq: int, Sk: int,
                      causal: bool, rows: int) -> list:
    """Every unit of work of the backward kernels for these sizes, as
    ``(kind, tile, head, batch, cost)``, heaviest first.

    A ``DKDV`` unit owns ``rows`` keys (tile ``t``: keys ``rows·t`` on) of
    kv head ``head`` and walks the ``H // KH`` query heads of its group,
    each over the 64-row query tiles from the tile of its first key on
    (all of them when not causal); a ``DQ`` unit owns ``rows`` queries of
    query head ``head`` and walks the 64-key tiles up to its last row's
    diagonal (all of them when not causal).  ``cost`` is the unit's
    products: 4 a dK/dV step, 3 a dQ step (:data:`BWD_STEP_COST`).  Units
    of equal cost keep the order kind, batch, head, tile, so the list is a
    pure function of its arguments; a unit with no step (keys past every
    query) is in it too, since it writes zeros.
    """
    G = H // KH
    n_q = math.ceil(Sq / BWD_STEP)
    units = []
    for b in range(B):
        for g in range(KH):
            for t in range(math.ceil(Sk / rows)):
                first = min(t * rows // BWD_STEP, n_q) if causal else 0
                units.append((DKDV, t, g, b,
                              BWD_STEP_COST[DKDV] * G * (n_q - first)))
        for h in range(H):
            for t in range(math.ceil(Sq / rows)):
                last = min(rows * (t + 1), Sq)
                end = min(Sk, last) if causal else Sk
                units.append((DQ, t, h, b,
                              BWD_STEP_COST[DQ] * math.ceil(end / BWD_STEP)))
    units.sort(key=lambda u: (-u[4], u[0], u[3], u[2], u[1]))
    return units


def backward_units(B: int, H: int, KH: int, Sq: int, Sk: int, causal: bool,
                   rows: int, device) -> torch.Tensor:
    """:func:`backward_schedule`'s units as an int32 ``(n, 4)`` tensor of
    ``(kind, tile, head, batch)`` on ``device``, which the backward kernels
    read (block ``i`` runs row ``i``).  Made once per shape and device and
    kept, so a training step copies nothing to the card; the key is the
    call's own shape (a tensor-parallel rank's local heads)."""
    key = (B, H, KH, Sq, Sk, bool(causal), rows, torch.device(device))
    with _units_lock:
        units = _units_cache.get(key)
        if units is None:
            rows_ = [u[:4] for u in backward_schedule(B, H, KH, Sq, Sk,
                                                      causal, rows)]
            units = torch.tensor(rows_, dtype=torch.int32).to(key[-1])
            _units_cache[key] = units
    return units


def backward_resources(dtype: torch.dtype, D: int, *,
                       aligned: bool = True) -> dict:
    """What the card gives the backward kernel that a call of ``dtype``
    and head dim ``D`` launches (``aligned`` as in :func:`route`):
    registers a thread, shared memory a block, local (spill) bytes a
    thread, threads a block and resident blocks and warps an SM, from
    ``cudaFuncGetAttributes`` and the occupancy calculator."""
    path = route(dtype, D, aligned=aligned)
    lib = _build.library()
    out = (ctypes.c_int * 5)()
    if path == "wgmma":
        err = lib.repro_flash_attention_bwd_bf16_wgmma_resources(D, out)
    else:
        vec = dtype == torch.float32 and D % 4 == 0 and aligned
        err = lib.repro_flash_attention_bwd_resources(
            int(dtype == torch.bfloat16), D, int(vec), out)
    _build.check(err, f"flash_attention_backward resources ({path})")
    regs, smem, local, threads, blocks = out
    return {"route": path, "registers": regs, "smem_bytes": smem,
            "local_bytes": local, "threads": threads,
            "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32}


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
    :func:`route` (the pre-pass ``delta = rowsum(dO ∘ O)``, then one launch
    of the dK/dV and dQ units of :func:`backward_units`; one launch in the
    counts) or raises; it never falls back.  On the card q, k, v, out and
    dout share a dtype, float32 or bfloat16, are contiguous, and ``1 <= D
    <= 128``; lse is a contiguous float32 ``(B, H, Sq)``.  With ``Sq ==
    0`` or ``Sk == 0`` the gradients are zeros and nothing launches.  ``flash_attention_backward.launches``
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
    units = backward_units(B, H, KH, Sq, Sk, causal, BWD_ROWS[path],
                           q.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, _BWD_ENTRY[path, q.dtype])(
        *(t.data_ptr() for t in (q, k, v, out, dout, lse, dq, dk, dv, delta,
                                 units)),
        units.shape[0], B, H, KH, Sq, Sk, D, int(causal), q.device.index,
        stream)
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

"""State-space blocks of the port: Mamba1 (selective scan) and Mamba2 (SSD).

Port of ``repro/models/ssm.py``.  Mamba1: the reference scans in chunks
with ``lax.scan`` and an associative scan inside each chunk; here the whole
sequence goes to the hand-written kernel
(:func:`repro_torch.kernels.ops.ssm_scan`), which carries the state through
every step itself and so needs no chunking.  Mamba2 (SSD, a scalar decay
per head): the reference's chunked dual form in torch ops, a Python loop
over chunks with the three contractions as batched products over (batch,
head); it has no TPU kernel, so it has no CUDA kernel either.  Decode is
the same call with ``S == 1`` from the cached state.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import p, rmsnorm


def dt_rank(cfg: ModelConfig) -> int:
    return math.ceil(cfg.d_model / 16)


def init_mamba1(name: str, cfg: ModelConfig, stacked: int = 0) -> Dict:
    d, di, N, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    R = dt_rank(cfg)
    L: Tuple[int, ...] = (stacked,) if stacked else ()
    return {
        "in_proj": p(f"{name}/in_proj", L + (d, 2 * di)),
        "conv_w": p(f"{name}/conv_w", L + (k, di), scale=k ** -0.5),
        "conv_b": p(f"{name}/conv_b", L + (di,), "zeros"),
        "x_proj": p(f"{name}/x_proj", L + (di, R + 2 * N)),
        "dt_proj": p(f"{name}/dt_proj", L + (R, di), scale=R ** -0.5),
        "dt_bias": p(f"{name}/dt_bias", L + (di,), "mamba_dt"),
        "A_log": p(f"{name}/A_log", L + (di, N), "mamba_A"),
        "D": p(f"{name}/D", L + (di,), "ones"),
        "out_proj": p(f"{name}/out_proj", L + (di, d)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: (B, S, C); w: (k, C).

    ``state`` is the trailing (k-1) inputs from the previous call (decode /
    chunk streaming); returns (output, new_state).  The new state is a copy,
    so a cache does not keep the whole padded input alive.
    """
    Bsz, S, C = x.shape
    k = w.shape[0]
    if state is None:
        state = torch.zeros((Bsz, k - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                   # (B, S+k-1, C)
    out = torch.zeros((Bsz, S, C), dtype=x.dtype, device=x.device)
    for i in range(k):                                   # k is 4: unrolled
        out = out + xp[:, i:i + S, :] * w[i].to(x.dtype)
    return out + b.to(x.dtype), xp[:, -(k - 1):, :].clone()


def selective_scan(xs: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor, A: torch.Tensor,
                   h0: Optional[torch.Tensor], *, impl: str = "kernel"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan in float32.

    xs, dt: (B, S, D);  Bc, Cc: (B, S, N);  A: (D, N) (negative reals).
    Returns (y: (B, S, D), h_final: (B, D, N)), both float32, as the
    reference does.  The inputs are widened to float32 and made contiguous
    here (``Bc`` and ``Cc`` are column slices of ``x_proj``'s output): the
    kernel takes contiguous tensors, not strides.  ``impl="ref"`` runs the
    plain version instead of the kernel.  Under autograd the kernel path
    differentiates through ``SSMScan`` (the scan's backward kernel on the
    card), the plain one through autograd of the plain scan.
    """
    xs, dt, Bc, Cc = (t.float().contiguous() for t in (xs, dt, Bc, Cc))
    h0 = None if h0 is None else h0.float().contiguous()
    return ops.ssm_scan(xs, dt, Bc, Cc, A.float().contiguous(), h0,
                        return_state=True, impl=impl)


def mamba1_block(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                 cache: Optional[Dict] = None, impl: str = "kernel"
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d).  cache = {"conv": (B,k-1,di), "h": (B,di,N)} for decode."""
    di, N = cfg.d_inner, cfg.ssm_state
    R = dt_rank(cfg)
    cd = cfg.cdtype

    xz = torch.matmul(x, params["in_proj"].to(cd))
    xs, z = torch.split(xz, di, dim=-1)

    conv_state = cache["conv"] if cache is not None else None
    xs, new_conv = _causal_conv(xs, params["conv_w"], params["conv_b"],
                                conv_state)
    xs = F.silu(xs)

    proj = torch.matmul(xs, params["x_proj"].to(cd))
    dt_lr, Bc, Cc = torch.split(proj, [R, N, N], dim=-1)
    dt = torch.matmul(dt_lr, params["dt_proj"].to(cd))
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())                     # (di, N)

    h0 = cache["h"] if cache is not None else None
    y, h = selective_scan(xs, dt, Bc, Cc, A, h0, impl=impl)
    y = (y + xs.float() * params["D"].float()).to(cd)
    y = y * F.silu(z)
    out = torch.matmul(y, params["out_proj"].to(cd))
    new_cache = {"conv": new_conv, "h": h} if cache is not None else None
    return out, new_cache


# --------------------------------------------------------------------------
# Mamba2 (SSD: scalar A per head, chunked dual form)
# --------------------------------------------------------------------------

def init_mamba2(name: str, cfg: ModelConfig, stacked: int = 0) -> Dict:
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H = cfg.n_ssm_heads
    conv_dim = di + 2 * N
    k = cfg.ssm_conv
    L: Tuple[int, ...] = (stacked,) if stacked else ()
    return {
        # order: [z (di), x (di), B (N), C (N), dt (H)]
        "in_proj": p(f"{name}/in_proj", L + (d, 2 * di + 2 * N + H)),
        "conv_w": p(f"{name}/conv_w", L + (k, conv_dim), scale=k ** -0.5),
        "conv_b": p(f"{name}/conv_b", L + (conv_dim,), "zeros"),
        "A_log": p(f"{name}/A_log", L + (H,), "mamba_A"),
        "dt_bias": p(f"{name}/dt_bias", L + (H,), "mamba_dt"),
        "D": p(f"{name}/D", L + (H,), "ones"),
        "norm": p(f"{name}/norm", L + (di,), "ones"),
        "out_proj": p(f"{name}/out_proj", L + (di, d)),
    }


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                Cc: torch.Tensor, A: torch.Tensor, h0: Optional[torch.Tensor],
                chunk: int, io_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (Mamba2) forward.

    xh: (B, S, H, P); dt: (B, S, H); Bc, Cc: (B, S, N); A: (H,) negative.
    Returns (y: (B, S, H, P), h_final: (B, H, P, N)), both float32.  One
    chunk of S when ``chunk`` does not divide S (served prompts, decode).

    ``io_dtype`` is the width of the large intra-chunk operands (x, B, C,
    the decay matrix), as in the reference; the state, dt and cumulative
    decays stay float32, and every product sums in float32 over operands
    rounded to ``io_dtype``.  Each contraction is a batched product over
    (batch, head), so no (B, Q, K, H, P) intermediate is formed.

    Unlike the reference (``repro/models/ssm.py:209-212``), the decay
    exponent ``cum_q - cum_k`` is masked to ``-inf`` above the diagonal
    *before* ``exp``: the values are the same (``exp(-inf) == 0``), but the
    masked entries no longer overflow to ``inf``, whose product with a zero
    cotangent makes the reference's gradient NaN at full-width chunks.
    """
    Bsz, S, H, P = xh.shape
    N = Bc.shape[-1]
    if S % chunk != 0:
        chunk = S
    nc = S // chunk

    def io(t):          # rounded to io_dtype, multiplied in float32
        return t.to(io_dtype).float()

    xh = io(xh.reshape(Bsz, nc, chunk, H, P))
    dt = dt.reshape(Bsz, nc, chunk, H).float()
    Bc = io(Bc.reshape(Bsz, nc, chunk, N))
    Cc = io(Cc.reshape(Bsz, nc, chunk, N))
    A = A.float()
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=xh.device).tril()[None, :, :, None]

    ys = []
    for c in range(nc):
        xc, dtc, bc, cc = xh[:, c], dt[:, c], Bc[:, c], Cc[:, c]
        cum = torch.cumsum(dtc * A, dim=1)                    # (B,Q,H)
        # intra-chunk (quadratic) term: masked "attention" with decay
        diff = cum[:, :, None, :] - cum[:, None, :, :]        # (B,Q,K,H)
        Lmat = io(torch.exp(torch.where(causal, diff, -math.inf)))
        scores = io(torch.matmul(cc, bc.transpose(1, 2)))     # (B,Q,K)
        att = io(scores[..., None] * Lmat)                    # (B,Q,K,H)
        xdt = xc * io(dtc)[..., None]                         # (B,K,H,P)
        y_intra = torch.matmul(att.permute(0, 3, 1, 2),
                               xdt.transpose(1, 2))           # (B,H,Q,P)
        # inter-chunk: the carried state, decayed from the chunk's start
        decay_in = io(torch.exp(cum))                         # (B,Q,H)
        y_inter = torch.matmul(cc[:, None], io(h).transpose(2, 3)) \
            * decay_in.transpose(1, 2)[..., None]             # (B,H,Q,P)
        ys.append((y_intra + y_inter).transpose(1, 2))        # (B,Q,H,P)
        # new state: h' = exp(sum dA) h + sum_k decay_to_end * dt x (x) B
        tot = cum[:, -1]                                      # (B,H)
        decay_out = io(torch.exp(tot[:, None] - cum))         # (B,K,H)
        u = xc * (decay_out * io(dtc))[..., None]             # (B,K,H,P)
        h = torch.exp(tot)[..., None, None] * h \
            + torch.matmul(u.permute(0, 2, 3, 1), bc[:, None])  # (B,H,P,N)
    return torch.cat(ys, dim=1), h


def mamba2_block(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                 cache: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d).  cache = {"conv": (B,k-1,conv_dim), "h": (B,H,P,N)}."""
    Bsz, S, _ = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    cd = cfg.cdtype

    zxbcdt = torch.matmul(x, params["in_proj"].to(cd))
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)

    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_state)
    xbc = F.silu(xbc)
    xs, Bc, Cc = torch.split(xbc, [di, N, N], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"].float())     # (B,S,H)
    A = -torch.exp(params["A_log"].float())                     # (H,)

    xh = xs.reshape(Bsz, S, H, P)
    h0 = cache["h"] if cache is not None else None
    y, h = ssd_chunked(xh, dt, Bc, Cc, A, h0, cfg.ssm_chunk,
                       io_dtype=(torch.bfloat16 if cfg.ssd_bf16
                                 else torch.float32))
    y = y + xh.float() * params["D"].float()[:, None]
    y = y.reshape(Bsz, S, di).to(cd)
    y = y * F.silu(z)
    y = rmsnorm(y, params["norm"], cfg.norm_eps)
    out = torch.matmul(y, params["out_proj"].to(cd))
    new_cache = {"conv": new_conv, "h": h} if cache is not None else None
    return out, new_cache


def mamba1_decode_cache(cfg: ModelConfig, batch: int,
                        dtype: torch.dtype = torch.float32,
                        device=None) -> Dict:
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }


def mamba2_decode_cache(cfg: ModelConfig, batch: int,
                        dtype: torch.dtype = torch.float32,
                        device=None) -> Dict:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                          cfg.ssm_state), dtype=torch.float32, device=device),
    }


def ssm_flops_per_token(cfg: ModelConfig, kind: str) -> int:
    """Matmul-ish FLOPs per token for one SSM layer (fwd)."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    if kind == "mamba1":
        R = dt_rank(cfg)
        f = 2 * d * 2 * di + 2 * di * (R + 2 * N) + 2 * R * di + 2 * di * d
        f += 2 * cfg.ssm_conv * di          # conv
        f += 6 * di * N                      # scan update+output (per token)
        return f
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    f = 2 * d * (2 * di + 2 * N + H) + 2 * di * d
    f += 2 * cfg.ssm_conv * (di + 2 * N)
    f += 2 * cfg.ssm_chunk * (N + H * P)     # intra-chunk quadratic amortized
    f += 6 * H * P * N                       # state update/output
    return f

"""State-space blocks of the port: Mamba1, through the selective-scan kernel.

Port of the Mamba1 half of ``repro/models/ssm.py``.  The reference scans in
chunks with ``lax.scan`` and an associative scan inside each chunk; here the
whole sequence goes to the hand-written kernel
(:func:`repro_torch.kernels.ops.ssm_scan`), which carries the state through
every step itself and so needs no chunking.  Decode is the same call with
``S == 1`` from the cached state.  Mamba2 (SSD) has no TPU kernel and waits
for its slice (ROADMAP §1 item 7).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import p


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


def mamba1_decode_cache(cfg: ModelConfig, batch: int,
                        dtype: torch.dtype = torch.float32,
                        device=None) -> Dict:
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
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

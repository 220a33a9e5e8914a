"""Mamba1 (falcon-mamba-7b as the port runs it), for configurations whose
``family`` is "ssm": token embedding, L × (RMSNorm, the selective-scan
mixer, residual), RMSNorm, an untied unembedding, float32 throughout.

The mixer: ``in_proj`` into x and z; a depthwise causal convolution of
width ``ssm_conv`` on x, then SiLU; ``x_proj`` into dt (rank ⌈d/16⌉), B and
C; dt = softplus(dt · dt_proj + dt_bias); A = −exp(A_log); the scan
h_t = exp(dt_t A) ∘ h_{t−1} + (dt_t x_t) B_tᵀ, y_t = h_t C_t from h_0 = 0;
y + D ∘ x, gated by SiLU(z); ``out_proj``.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from ..tree import Leaf, lm_leaves
from .ops import layer_slice, mm, next_token_loss, rmsnorm, silu, softplus


def dt_rank(cfg: Dict) -> int:
    return math.ceil(cfg["d_model"] / 16)


def leaves(cfg: Dict) -> List[Leaf]:
    """The common leaves, then each layer's mixer."""
    d, L = cfg["d_model"], cfg["n_layers"]
    di = cfg["ssm_expand"] * d
    N, k, R = cfg["ssm_state"], cfg["ssm_conv"], dt_rank(cfg)
    return lm_leaves(cfg) + [
        Leaf("layers/mixer/in_proj", (L, d, 2 * di), "normal"),
        Leaf("layers/mixer/conv_w", (L, k, di), "normal", k ** -0.5),
        Leaf("layers/mixer/conv_b", (L, di), "zeros"),
        Leaf("layers/mixer/x_proj", (L, di, R + 2 * N), "normal"),
        Leaf("layers/mixer/dt_proj", (L, R, di), "normal", R ** -0.5),
        Leaf("layers/mixer/dt_bias", (L, di), "mamba_dt"),
        Leaf("layers/mixer/A_log", (L, di, N), "mamba_A"),
        Leaf("layers/mixer/D", (L, di), "ones"),
        Leaf("layers/mixer/out_proj", (L, di, d), "normal")]


class SelectiveScan(torch.autograd.Function):
    """The scan step by step over time, with its gradient written out: the
    forward keeps every state h_t (S, B, D, N), the backward runs the
    adjoint recurrence dh_t = dy_t C_t + exp(dt_{t+1} A) ∘ dh_{t+1} back
    over time and forms each input's gradient from it."""

    @staticmethod
    def forward(ctx, x, dt, Bm, Cm, A):
        # time leading, so that each step's slice is contiguous
        x_s, dt_s = x.transpose(0, 1), dt.transpose(0, 1)      # (S, B, D)
        B_s, C_s = Bm.transpose(0, 1), Cm.transpose(0, 1)      # (S, B, N)
        a = torch.exp(dt_s[..., None] * A)                     # (S, B, D, N)
        H = (dt_s * x_s)[..., None] * B_s[:, :, None, :]       # the inputs,
        for t in range(1, H.shape[0]):                         # then states
            torch.addcmul(H[t], a[t], H[t - 1], out=H[t])
        y = torch.einsum("sbdn,sbn->bsd", H, C_s)
        ctx.save_for_backward(x, dt, Bm, Cm, A, H)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, Bm, Cm, A, H = ctx.saved_tensors
        x_s, dt_s = x.transpose(0, 1), dt.transpose(0, 1)
        B_s, C_s = Bm.transpose(0, 1), Cm.transpose(0, 1)
        dy_s = dy.transpose(0, 1)
        a = torch.exp(dt_s[..., None] * A)
        dH = dy_s[..., None] * C_s[:, :, None, :]              # dy_t C_t, then
        for t in range(dH.shape[0] - 2, -1, -1):               # dh_t
            torch.addcmul(dH[t], a[t + 1], dH[t + 1], out=dH[t])
        dC = torch.einsum("sbdn,sbd->bsn", H, dy_s)
        dtx = dt_s * x_s
        dB = torch.einsum("sbdn,sbd->bsn", dH, dtx)
        d_dtx = torch.einsum("sbdn,sbn->sbd", dH, B_s)
        # dL/d(dt·A) at each element: dh_t ∘ h_{t−1} ∘ exp(dt_t A)
        W = dH
        W[1:].mul_(H[:-1])
        W[0].zero_()
        W.mul_(a)
        del a
        dA = torch.einsum("sbdn,sbd->dn", W, dt_s)
        ddt = torch.einsum("sbdn,dn->sbd", W, A) + d_dtx * x_s
        dx = d_dtx * dt_s
        return (dx.transpose(0, 1), ddt.transpose(0, 1), dB, dC, dA)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal convolution of x (B, S, C) by w (k, C)."""
    k, S = w.shape[0], x.shape[1]
    xp = torch.cat([x.new_zeros(x.shape[0], k - 1, x.shape[2]), x], dim=1)
    return sum(xp[:, i:i + S] * w[i] for i in range(k)) + b


def layer(x: torch.Tensor, lp: Dict, cfg: Dict, precision: str
          ) -> torch.Tensor:
    mix = lp["mixer"]
    di, N = cfg["ssm_expand"] * cfg["d_model"], cfg["ssm_state"]
    R = dt_rank(cfg)
    h = rmsnorm(x, lp["norm1"]["scale"], cfg["norm_eps"])
    xs, z = torch.split(mm(h, mix["in_proj"], precision), di, dim=-1)
    xs = silu(causal_conv(xs, mix["conv_w"], mix["conv_b"]))
    dt, Bm, Cm = torch.split(mm(xs, mix["x_proj"], precision), [R, N, N],
                             dim=-1)
    dt = softplus(mm(dt, mix["dt_proj"], precision) + mix["dt_bias"])
    A = -torch.exp(mix["A_log"])
    y = SelectiveScan.apply(xs.contiguous(), dt.contiguous(),
                            Bm.contiguous(), Cm.contiguous(), A)
    y = (y + xs * mix["D"]) * silu(z)
    return x + mm(y, mix["out_proj"], precision)


def loss(params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
         cfg: Dict, precision: str, run_layer) -> torch.Tensor:
    x = params["embed"]["tok"][tokens.long()]
    for i in range(cfg["n_layers"]):
        x = run_layer(lambda x, i=i: layer(
            x, layer_slice(params["layers"], i), cfg, precision), x)
    x = rmsnorm(x, params["final_norm"]["scale"], cfg["norm_eps"])
    return next_token_loss(
        mm(x, params["embed"]["unembed"], precision, store=False), labels)

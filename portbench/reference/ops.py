"""Plain building blocks of the reference: products at a stated precision,
norms, rotary embeddings, blocked causal attention with its gradient, and
the loss, and one layer of stacked layers."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

_FP8_MAX = 448.0      # largest finite float8 e4m3


def rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` as a product's operand: as it is in float32, or rounded to
    float8 e4m3 under a per-tensor scale (amax to the format's largest)."""
    if precision == "float32":
        return t
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    scale = t.detach().abs().amax().clamp(min=1e-30) / _FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()        # the rounded value, t's gradient


def mm(a: torch.Tensor, b: torch.Tensor, precision: str,
       store: bool = True) -> torch.Tensor:
    """``a @ b`` summed in float32 from operands at ``precision``; with
    ``store`` the result is rounded to ``precision`` too, as an activation
    the model keeps at its compute precision (the configurations keep
    theirs in bf16, so the control keeps them in fp8)."""
    out = torch.matmul(rounded(a, precision), rounded(b, precision))
    return rounded(out, precision) if store else out


def layer_slice(tree: Dict, i: int) -> Dict:
    """Layer ``i`` of a tree of stacked layers."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated by position 0..S-1, the two halves of the
    head dim rotated together (not interleaved pairs)."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                         device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# query rows of one block of the attention: its scores are ROWS × S floats
_SCORE_FLOATS = 1 << 28


class CausalAttention(torch.autograd.Function):
    """Softmax attention of q (B, H, S, D) over k, v (B, KH, S, D), causal,
    each kv head's G = H / KH query heads folded into its rows and taken in
    blocks of rows, so that no (H, S, S) score tensor is ever formed.  It
    keeps q, k, v, the output and each row's log-sum-exp, and re-forms the
    probabilities block by block in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, precision):
        B, H, S, D = q.shape
        KH = k.shape[1]
        G = H // KH
        rows = max(1, _SCORE_FLOATS // S)
        scale = D ** -0.5
        out = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=q.dtype, device=q.device)
        kpos = torch.arange(S, device=q.device)
        for b in range(B):
            for j in range(KH):
                qj = q[b, j * G:(j + 1) * G].reshape(G * S, D)
                kj, vj = k[b, j], v[b, j]
                oj = out[b, j * G:(j + 1) * G].view(G * S, D)
                lj = lse[b, j * G:(j + 1) * G].view(G * S)
                for r in range(0, G * S, rows):
                    qb = qj[r:r + rows]
                    s = mm(qb, kj.t(), precision, store=False) * scale
                    qpos = torch.arange(r, r + qb.shape[0],
                                        device=q.device) % S
                    s.masked_fill_(kpos[None, :] > qpos[:, None],
                                   -math.inf)
                    lj[r:r + rows] = torch.logsumexp(s, dim=-1)
                    p = torch.exp(s - lj[r:r + rows, None])
                    oj[r:r + rows] = mm(p, vj, precision)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.precision = precision
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        precision = ctx.precision
        B, H, S, D = q.shape
        KH = k.shape[1]
        G = H // KH
        rows = max(1, _SCORE_FLOATS // S)
        scale = D ** -0.5
        dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        kpos = torch.arange(S, device=q.device)
        for b in range(B):
            for j in range(KH):
                heads = slice(j * G, (j + 1) * G)
                qj = q[b, heads].reshape(G * S, D)
                doj = dout[b, heads].reshape(G * S, D)
                delta = (doj * out[b, heads].reshape(G * S, D)).sum(-1)
                lj = lse[b, heads].reshape(G * S)
                kj, vj = k[b, j], v[b, j]
                dqj = dq[b, heads].view(G * S, D)
                for r in range(0, G * S, rows):
                    qb, dob = qj[r:r + rows], doj[r:r + rows]
                    s = mm(qb, kj.t(), precision, store=False) * scale
                    qpos = torch.arange(r, r + qb.shape[0],
                                        device=q.device) % S
                    s.masked_fill_(kpos[None, :] > qpos[:, None],
                                   -math.inf)
                    p = torch.exp(s - lj[r:r + rows, None])
                    del s
                    dv[b, j] += mm(p.t(), dob, precision, store=False)
                    ds = mm(dob, vj.t(), precision, store=False)
                    ds.sub_(delta[r:r + rows, None]).mul_(p)
                    del p
                    dqj[r:r + rows] = mm(ds, kj, precision, store=False) * scale
                    dk[b, j] += mm(ds.t(), qb, precision, store=False) * scale
        return dq, dk, dv, None


def attention(q, k, v, precision: str) -> torch.Tensor:
    return CausalAttention.apply(q, k, v, precision)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def next_token_loss(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """The mean cross-entropy of ``logits[:, t]`` against ``labels[:, t +
    1]`` over positions 0..S-2, the program's loss; the benchmark's feed
    gives labels equal to the tokens, so it is the next token's loss."""
    z = logits[:, :-1]
    gold = torch.gather(z, -1, labels[:, 1:, None].long())[..., 0]
    return torch.mean(torch.logsumexp(z, dim=-1) - gold)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x)

"""Shared layers of the port's models (plain functions on tensors).

Port of ``repro/models/layers.py``: the parameter initialisers of
``Builder.p`` (``layers.py:37-61``), the norms (``rmsnorm``, ``layernorm``,
``apply_norm``), rotary embeddings, GQA attention with a KV cache (plain or
int8), the MLP (``swiglu`` or ``gelu``) and the token embedding and
unembedding.  Prefill attention goes through the flash-attention kernel
(:func:`repro_torch.kernels.ops.flash_attention`); attention over a cache
that already holds tokens stays torch ops.  The reference's sharding
constraints (``shard_act``) have nothing to do on one device and are left
out.

Parameters are the reference's tree: nested dicts of tensors, keyed and
shaped as ``repro.models.transformer.init_params`` makes them, so a tree
carried across with ``interop.params_from_numpy`` plugs in as it is.
Compute runs in ``cfg.cdtype``; norm statistics and logits in float32.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter as ``Builder.p`` declares it: its name (what the
    random stream is folded from), shape, initialiser and scale."""
    name: str
    shape: Tuple[int, ...]
    init: str = "normal"            # normal | zeros | ones | mamba_A | mamba_dt
    scale: Optional[float] = None

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def p(name: str, shape: Tuple[int, ...], init: str = "normal",
      scale: Optional[float] = None) -> ParamSpec:
    return ParamSpec(name, tuple(shape), init, scale)


def param_seed(seed: int, name: str) -> int:
    """The generator seed of parameter ``name``: ``seed`` with the name's
    CRC-32 folded in, as ``Builder.p`` folds it into its key, so a
    parameter's values do not depend on the order parameters are made in.
    ``seed`` is spread over all 63 bits first: the CPU generator reads only
    the low 32."""
    return (seed * 0x9E3779B97F4A7C15 + zlib.crc32(name.encode())) \
        & 0x7FFFFFFFFFFFFFFF


def init_param(spec: ParamSpec, seed: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """Draw one parameter on ``device`` with the distribution ``Builder.p``
    gives it (``layers.py:43-61``): normal with ``fan_in ** -0.5`` unless a
    scale is given, zeros, ones, ``mamba_A`` (log of 1..N) or ``mamba_dt``
    (inverse softplus of a log-uniform dt in [1e-3, 1e-1]).

    The values come from a ``torch.Generator`` on ``device`` seeded with
    :func:`param_seed`; they follow the same distributions as the
    reference's ``jax.random`` draws but are not the same numbers.  Random
    values are drawn on the device itself, never on the host.
    """
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if spec.init == "mamba_A":      # log-spaced negative eigenvalues
        n = shape[-1]
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        return torch.log(a).expand(shape).to(dtype).contiguous()
    gen = torch.Generator(device=device)
    gen.manual_seed(param_seed(seed, spec.name))
    if spec.init == "normal":
        scale = spec.scale
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = fan_in ** -0.5
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dtype)
    if spec.init == "mamba_dt":     # dt bias so softplus(dt) in [1e-3, 1e-1]
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        lo, hi = math.log(1e-3), math.log(0.1)
        dtv = torch.exp(u * (hi - lo) + lo)
        return (dtv + torch.log(-torch.expm1(-dtv))).to(dtype)
    raise ValueError(f"unknown initialiser {spec.init!r}")


def init_embed(cfg: ModelConfig) -> Dict:
    out = {"tok": p("embed/tok", (cfg.vocab_size, cfg.d_model), scale=1.0)}
    if not cfg.use_rope:
        out["pos"] = p("embed/pos", (8192, cfg.d_model), scale=0.02)
    if not cfg.tie_embeddings:
        out["unembed"] = p("embed/unembed", (cfg.d_model, cfg.vocab_size))
    return out


def init_norm(name: str, cfg: ModelConfig, dim: Optional[int] = None,
              stacked: int = 0) -> Dict:
    shape = ((stacked,) if stacked else ()) + (dim or cfg.d_model,)
    out = {"scale": p(f"{name}/scale", shape, "ones")}
    if cfg.norm_type == "layernorm":
        out["bias"] = p(f"{name}/bias", shape, "zeros")
    return out


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x: torch.Tensor, params: Dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm_type == "layernorm":
        return layernorm(x, params["scale"], params["bias"], cfg.norm_eps)
    return rmsnorm(x, params["scale"], cfg.norm_eps)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integer.  Rotates the two halves
    of the head dim (not interleaved pairs), as the reference does."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (D/2,)
    ang = positions[..., None].float() * freqs                  # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def init_attention(name: str, cfg: ModelConfig, stacked: int = 0) -> Dict:
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L: Tuple[int, ...] = (stacked,) if stacked else ()
    out = {
        "wq": p(f"{name}/wq", L + (d, H * hd)),
        "wk": p(f"{name}/wk", L + (d, KH * hd)),
        "wv": p(f"{name}/wv", L + (d, KH * hd)),
        "wo": p(f"{name}/wo", L + (H * hd, d)),
    }
    if cfg.qkv_bias:
        out["bq"] = p(f"{name}/bq", L + (H * hd,), "zeros")
        out["bk"] = p(f"{name}/bk", L + (KH * hd,), "zeros")
        out["bv"] = p(f"{name}/bv", L + (KH * hd,), "zeros")
    if cfg.qk_norm:
        out["q_norm"] = p(f"{name}/q_norm", L + (hd,), "ones")
        out["k_norm"] = p(f"{name}/k_norm", L + (hd,), "ones")
    return out


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the head_dim axis: x (B, S, KH, hd) ->
    (int8 values, bf16 scales (B, S, KH))."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, q_pos: Optional[torch.Tensor] = None,
                     kv_len: Optional[torch.Tensor] = None,
                     grouped: bool = False) -> torch.Tensor:
    """Attention in torch ops, for queries over a cache (decode).

    q: (B, Sq, H, D); k, v: (B, Sk, KH, D).  ``kv_len`` (B,) masks cache
    slots at or past the valid length; ``q_pos`` (B, Sq) gives the queries'
    absolute positions for the causal mask.  ``grouped`` contracts K/V in
    their KH-head layout instead of repeating them to H heads.  Scores are
    float32 (the exact products of the compute-type operands, as the
    reference's ``preferred_element_type=float32`` gives them); the
    probabilities are cast to ``v.dtype`` before ``p @ v``, as there.
    """
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = D ** -0.5
    kpos = torch.arange(Sk, device=q.device)
    if grouped and G > 1:
        qg = q.reshape(B, Sq, KH, G, D)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                              k.float()) * scale
        expand = (slice(None), None, None, slice(None), None)   # b,-,-,q,-
    else:
        k = _repeat_kv(k, G)
        v = _repeat_kv(v, G)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        expand = (slice(None), None, slice(None), None)         # b,-,q,-
    mask = torch.zeros((), dtype=torch.bool, device=q.device)
    if causal:
        qpos = (q_pos if q_pos is not None
                else torch.arange(Sq, device=q.device)[None, :])
        mask = mask | (kpos > qpos[expand])
    if kv_len is not None:
        mask = mask | (kpos >= kv_len[(slice(None),) + (None,) *
                                      (logits.dim() - 1)])
    logits = torch.where(mask, -1e30, logits)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    if grouped and G > 1:
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
        return out.reshape(B, Sq, H, D)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_block(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, cache: Optional[Dict] = None,
                    cache_pos: int = 0, causal: bool = True,
                    impl: str = "kernel"
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA attention with an optional KV cache; returns (out, new_cache).

    * no cache: self-attention over ``x`` (B, S, d);
    * a cache with ``cache_pos == 0``: prefill, writing the first S slots;
    * a cache with ``cache_pos > 0``: decode (or a later chunk), writing
      slots ``cache_pos .. cache_pos + S - 1`` and attending over the slots
      written so far.

    The cache holds (B, S_max, KH, hd) k and v in the compute type, or int8
    with bf16 scales per (token, head).  It is not changed: the written
    copy is returned, as the reference's ``dynamic_update_slice`` does.

    When the queries start at position 0 (no cache, or ``cache_pos == 0``)
    the attention is the flash-attention kernel's (``impl="ref"``: its plain
    version) over the k, v the reference attends over: with an int8 cache,
    the dequantized first S slots.  Every other call attends over the cache
    with :func:`attention_scores`.  At bf16 compute the reference rounds the
    probabilities to bf16 before ``p @ v``, and so does the kernel's wgmma
    route, which takes every bf16 call with ``hd % 8 == 0`` on 16-byte
    aligned tensors (every call made here).  Only the plain version
    (``impl="ref"``, :func:`repro_torch.kernels.ref.attention`) and the simt
    route keep them in float32, so those differ from the reference by bf16
    rounding.  In float32 they all agree.
    """
    B, S, _ = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd = cfg.cdtype

    q = torch.matmul(x, params["wq"].to(cd))
    k = torch.matmul(x, params["wk"].to(cd))
    v = torch.matmul(x, params["wv"].to(cd))
    if "bq" in params:
        q = q + params["bq"].to(cd)
        k = k + params["bk"].to(cd)
        v = v + params["bv"].to(cd)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KH, hd)
    v = v.reshape(B, S, KH, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        end = cache_pos + S
        if end > cache["k"].shape[1]:
            raise ValueError(f"the cache holds {cache['k'].shape[1]} slots; "
                             f"writing {S} at {cache_pos} overruns it")
        new_cache = {name: t.clone() for name, t in cache.items()}
        if "k_scale" in cache:
            ks, ksc = _quantize_kv(k)
            vs, vsc = _quantize_kv(v)
            new_cache["k"][:, cache_pos:end] = ks
            new_cache["v"][:, cache_pos:end] = vs
            new_cache["k_scale"][:, cache_pos:end] = ksc
            new_cache["v_scale"][:, cache_pos:end] = vsc
            k = new_cache["k"].to(cd) * new_cache["k_scale"][..., None].to(cd)
            v = new_cache["v"].to(cd) * new_cache["v_scale"][..., None].to(cd)
        else:
            new_cache["k"][:, cache_pos:end] = k.to(cache["k"].dtype)
            new_cache["v"][:, cache_pos:end] = v.to(cache["v"].dtype)
            k, v = new_cache["k"].to(cd), new_cache["v"].to(cd)

    if cache is None or cache_pos == 0:
        # the slots past S are masked by kv_len in the reference: attend
        # over the first S only
        out = ops.flash_attention(
            q.transpose(1, 2).contiguous(),
            k[:, :S].transpose(1, 2).contiguous(),
            v[:, :S].transpose(1, 2).contiguous(), causal=causal, impl=impl)
        out = out.transpose(1, 2)
    else:
        kv_len = torch.full((B,), cache_pos + S, device=x.device)
        out = attention_scores(q, k, v, causal=causal,
                               q_pos=positions if causal else None,
                               kv_len=kv_len, grouped=cfg.gqa_grouped)
    out = out.reshape(B, S, H * hd)
    return torch.matmul(out, params["wo"].to(cd)), new_cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def init_mlp(name: str, cfg: ModelConfig, stacked: int = 0) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    L: Tuple[int, ...] = (stacked,) if stacked else ()
    if cfg.mlp_act == "swiglu":
        return {"wi_gate": p(f"{name}/wi_gate", L + (d, ff)),
                "wi_up": p(f"{name}/wi_up", L + (d, ff)),
                "wo": p(f"{name}/wo", L + (ff, d))}
    return {"wi": p(f"{name}/wi", L + (d, ff)),
            "bi": p(f"{name}/bi", L + (ff,), "zeros"),
            "wo": p(f"{name}/wo", L + (ff, d)),
            "bo": p(f"{name}/bo", L + (d,), "zeros")}


def mlp_block(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cd = cfg.cdtype
    if "wi_gate" in params:
        g = torch.matmul(x, params["wi_gate"].to(cd))
        u = torch.matmul(x, params["wi_up"].to(cd))
        return torch.matmul(F.silu(g) * u, params["wo"].to(cd))
    h = torch.matmul(x, params["wi"].to(cd)) + params["bi"].to(cd)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h, approximate="tanh")
    return torch.matmul(h, params["wo"].to(cd)) + params["bo"].to(cd)


# --------------------------------------------------------------------------
# embeddings
# --------------------------------------------------------------------------

def embed_tokens(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = F.embedding(tokens, params["tok"]).to(cfg.cdtype)
    if not cfg.use_rope and positions is not None:
        x = x + F.embedding(positions, params["pos"]).to(cfg.cdtype)
    return x


def unembed(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """float32 logits of ``x`` in ``cfg.cdtype``, as the reference's einsum
    with ``preferred_element_type=float32`` gives them: the weight is
    rounded to the compute type, and the product of two such values is
    exact in float32, so widening both operands and multiplying in float32
    computes the same function (a bf16 product would round the logits to
    bf16 and move greedy choices on near-ties)."""
    w = params["tok"].t() if cfg.tie_embeddings else params["unembed"]
    w = w.to(cfg.cdtype)
    logits = torch.matmul(x.float(), w.float())
    if cfg.logit_softcap > 0.0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits

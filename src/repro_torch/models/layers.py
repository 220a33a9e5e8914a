"""Shared layers of the port's models (plain functions on tensors).

Port of ``repro/models/layers.py``: the parameter initialisers of
``Builder.p`` (``layers.py:37-61``), the norms (``rmsnorm``, ``layernorm``,
``apply_norm``), rotary embeddings, GQA attention with a KV cache (plain or
int8), the MLP (``swiglu`` or ``gelu``) and the token embedding and
unembedding.  Prefill and cross-attention go through the flash-attention
kernel (:func:`repro_torch.kernels.ops.flash_attention`); attention over a
cache that already holds tokens stays torch ops.

On a mesh (the launchers' world path) the blocks run on DTensors: the
parameters laid out by the rule table, and :func:`shard_act` at the
reference's constraint sites (q by heads, the MLP's hidden by ``d_ff``).
A packed ``(B, S, n * hd)`` projection is split into ``n`` heads only over
the mesh dims that divide ``n`` (the rest replicated first), so a reduced
model's 2 kv heads on a model axis of 4 are replicated there, where GSPMD
pads and reshards.  The flash kernel runs on each rank's batch rows and
heads (``kernels/sharded.py``), and so does a decode step's attention over
the cache (:func:`attention_scores` on local shards).  An embedding table
sharded by vocab is looked up on each rank's rows and the masked rows
summed.  Plain tensors made here (RoPE frequencies, positions, masks)
become replicated DTensors (``parallel.sharding.replicated_like``) before
they meet the DTensors.

Parameters are the reference's tree: nested dicts of tensors, keyed and
shaped as ``repro.models.transformer.init_params`` makes them, so a tree
carried across with ``interop.params_from_numpy`` plugs in as it is.
Compute runs in ``cfg.cdtype``; norm statistics and logits in float32.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import zlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel.sharding import is_dtensor, replicated_like
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter as ``Builder.p`` declares it: its name (what the
    random stream is folded from), shape, initialiser and scale, and the
    logical name of each of its axes (``Builder(mode="axes")``'s mirror:
    what the placement rules map onto mesh axes)."""
    name: str
    shape: Tuple[int, ...]
    init: str = "normal"            # normal | zeros | ones | mamba_A | mamba_dt
    scale: Optional[float] = None
    axes: Optional[Tuple[Optional[str], ...]] = None

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def p(name: str, shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
      init: str = "normal", scale: Optional[float] = None) -> ParamSpec:
    if len(shape) != len(axes):
        raise ValueError(f"{name}: shape {tuple(shape)} has {len(shape)} "
                         f"axes, names {tuple(axes)}")
    return ParamSpec(name, tuple(shape), init, scale, tuple(axes))


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
    out = {"tok": p("embed/tok", (cfg.vocab_size, cfg.d_model),
                   ("vocab", "embed"), scale=1.0)}
    if not cfg.use_rope:
        out["pos"] = p("embed/pos", (8192, cfg.d_model), (None, "embed"),
                       scale=0.02)
    if not cfg.tie_embeddings:
        out["unembed"] = p("embed/unembed", (cfg.d_model, cfg.vocab_size),
                           ("embed", "vocab"))
    return out


def init_norm(name: str, cfg: ModelConfig, dim: Optional[int] = None,
              stacked: int = 0) -> Dict:
    shape = ((stacked,) if stacked else ()) + (dim or cfg.d_model,)
    axes = (("layers",) if stacked else ()) + ("norm_dim",)
    out = {"scale": p(f"{name}/scale", shape, axes, "ones")}
    if cfg.norm_type == "layernorm":
        out["bias"] = p(f"{name}/bias", shape, axes, "zeros")
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
    """The config's norm of ``x``.  A DTensor that is a partial sum (the
    residual stream after a row-parallel projection's output was added)
    is summed first, as Megatron all-reduces there: a norm needs the whole
    value, and DTensor would otherwise sum only its variance and keep the
    normed output partial, which the next projection can take only by
    gathering its weight whole and all-reducing its output."""
    if is_dtensor(x) and any(p.is_partial() for p in x.placements):
        from torch.distributed.tensor import Replicate
        x = x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                           else p for p in x.placements])
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
    freqs = replicated_like(rope_freqs(x.shape[-1], theta, x.device),
                            positions)                          # (D/2,)
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
    A: Tuple[str, ...] = ("layers",) if stacked else ()
    out = {
        "wq": p(f"{name}/wq", L + (d, H * hd), A + ("embed", "heads_dim")),
        "wk": p(f"{name}/wk", L + (d, KH * hd), A + ("embed", "kv_dim")),
        "wv": p(f"{name}/wv", L + (d, KH * hd), A + ("embed", "kv_dim")),
        "wo": p(f"{name}/wo", L + (H * hd, d), A + ("heads_dim", "embed")),
    }
    if cfg.qkv_bias:
        out["bq"] = p(f"{name}/bq", L + (H * hd,), A + ("heads_dim",),
                      "zeros")
        out["bk"] = p(f"{name}/bk", L + (KH * hd,), A + ("kv_dim",),
                      "zeros")
        out["bv"] = p(f"{name}/bv", L + (KH * hd,), A + ("kv_dim",),
                      "zeros")
    if cfg.qk_norm:
        out["q_norm"] = p(f"{name}/q_norm", L + (hd,), A + ("norm_dim",),
                          "ones")
        out["k_norm"] = p(f"{name}/k_norm", L + (hd,), A + ("norm_dim",),
                          "ones")
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
    if is_dtensor(q):
        from ..kernels import sharded
        return sharded.heads_call(functools.partial(
            attention_scores, causal=causal, grouped=grouped),
            q, k, v, 2, q_pos=q_pos, kv_len=kv_len)
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


def shard_act(x: torch.Tensor, axes: Tuple[Optional[str], ...],
              ctx) -> torch.Tensor:
    """An activation sharding constraint when a mesh context is active
    (``ShardingCtx.fit``: even shards), else ``x``."""
    if ctx is None or ctx.mesh is None:
        return x
    return ctx.fit(x, axes)


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """``t`` (B, S, n * hd) as (B, S, n, hd).  On a DTensor the packed dim
    stays sharded only over the mesh dims that divide ``n``: a head is
    never split between ranks."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        mesh = t.device_mesh
        want = [Replicate() if pl == Shard(2) and n % mesh.size(i) else pl
                for i, pl in enumerate(t.placements)]
        if want != list(t.placements):
            t = t.redistribute(mesh, want)
    return t.reshape(t.shape[0], t.shape[1], n, hd)


def attention_block(params: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, cache: Optional[Dict] = None,
                    cache_pos: int = 0, causal: bool = True,
                    kv_override: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    impl: str = "kernel", ctx=None
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA attention with an optional KV cache; returns (out, new_cache).

    * no cache: self-attention over ``x`` (B, S, d);
    * a cache with ``cache_pos == 0``: prefill, writing the first S slots;
    * a cache with ``cache_pos > 0``: decode (or a later chunk), writing
      slots ``cache_pos .. cache_pos + S - 1`` and attending over the slots
      written so far;
    * ``kv_override=(k, v)``, each (B, Sk, KH, hd) in the compute type:
      cross-attention of ``x``'s queries over them (the encoder-decoder's).
      The k and v projections, ``k_norm``, RoPE (on q too, as the
      reference skips it) and the cache are skipped; ``bq`` and ``q_norm``
      apply.  It is always the flash kernel's, over all Sk keys, also for
      a decode step's one query, as the reference gives it no cache and no
      ``kv_len``.

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
    if "bq" in params:
        q = q + params["bq"].to(cd)
    q = split_heads(q, H, hd)
    if kv_override is None:
        k = torch.matmul(x, params["wk"].to(cd))
        v = torch.matmul(x, params["wv"].to(cd))
        if "bk" in params:
            k = k + params["bk"].to(cd)
            v = v + params["bv"].to(cd)
        k = split_heads(k, KH, hd)
        v = split_heads(v, KH, hd)
    else:
        k, v = kv_override
        cache = None
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        if kv_override is None:
            k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if cfg.use_rope and kv_override is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    q = shard_act(q, ("batch", "seq", "heads", None), ctx)
    new_cache = None
    if cache is not None:
        end = cache_pos + S
        if end > cache["k"].shape[1]:
            raise ValueError(f"the cache holds {cache['k'].shape[1]} slots; "
                             f"writing {S} at {cache_pos} overruns it")
        new_cache = {name: t.clone() for name, t in cache.items()}
        # the written rows laid out as the cache is
        k = shard_act(k, ("batch", "seq", "kv_heads", None), ctx)
        v = shard_act(v, ("batch", "seq", "kv_heads", None), ctx)
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
        # over the first S only (an override's keys: all of them)
        Sk = S if kv_override is None else k.shape[1]
        out = ops.flash_attention(
            q.transpose(1, 2).contiguous(),
            k[:, :Sk].transpose(1, 2).contiguous(),
            v[:, :Sk].transpose(1, 2).contiguous(), causal=causal, impl=impl)
        out = out.transpose(1, 2)
    else:
        kv_len = replicated_like(torch.full((B,), cache_pos + S,
                                            device=x.device), x)
        out = attention_scores(q, k, v, causal=causal,
                               q_pos=positions if causal else None,
                               kv_len=kv_len, grouped=cfg.gqa_grouped)
    out = _grad_as_forward(out.reshape(B, S, H * hd))
    return torch.matmul(out, params["wo"].to(cd)), new_cache


class _GradAsForward(torch.autograd.Function):
    """The identity on a DTensor, whose gradient is redistributed to the
    placements the forward had.  After a heads merge, the projection by
    ``wo`` hands back a gradient sharded on the merged dim; where the
    heads do not divide the mesh dim (qwen2-7b's 28 on 16), the merge's
    backward, a view that splits that dim, cannot take it (torch 2.11's
    DTensor raises there; later ones redistribute inside the view)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements)


def _grad_as_forward(x: torch.Tensor) -> torch.Tensor:
    return _GradAsForward.apply(x) if is_dtensor(x) else x


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def init_mlp(name: str, cfg: ModelConfig, stacked: int = 0) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff
    L: Tuple[int, ...] = (stacked,) if stacked else ()
    A: Tuple[str, ...] = ("layers",) if stacked else ()
    if cfg.mlp_act == "swiglu":
        return {"wi_gate": p(f"{name}/wi_gate", L + (d, ff),
                             A + ("embed", "d_ff")),
                "wi_up": p(f"{name}/wi_up", L + (d, ff),
                           A + ("embed", "d_ff")),
                "wo": p(f"{name}/wo", L + (ff, d), A + ("d_ff", "embed"))}
    return {"wi": p(f"{name}/wi", L + (d, ff), A + ("embed", "d_ff")),
            "bi": p(f"{name}/bi", L + (ff,), A + ("d_ff",), "zeros"),
            "wo": p(f"{name}/wo", L + (ff, d), A + ("d_ff", "embed")),
            "bo": p(f"{name}/bo", L + (d,), A + ("norm_dim",), "zeros")}


def mlp_block(params: Dict, x: torch.Tensor, cfg: ModelConfig,
              ctx=None) -> torch.Tensor:
    cd = cfg.cdtype
    if "wi_gate" in params:
        g = torch.matmul(x, params["wi_gate"].to(cd))
        u = torch.matmul(x, params["wi_up"].to(cd))
        h = shard_act(F.silu(g) * u, ("batch", "seq", "d_ff"), ctx)
        return torch.matmul(h, params["wo"].to(cd))
    h = torch.matmul(x, params["wi"].to(cd)) + params["bi"].to(cd)
    # jax.nn.gelu defaults to the tanh approximation
    h = shard_act(F.gelu(h, approximate="tanh"), ("batch", "seq", "d_ff"),
                  ctx)
    return torch.matmul(h, params["wo"].to(cd)) + params["bo"].to(cd)


# --------------------------------------------------------------------------
# embeddings
# --------------------------------------------------------------------------

def _lookup(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)``.  On a DTensor table the shards of its
    feature dim are gathered first (FSDP's gather before use) and those of
    its rows (the vocab) kept: each rank looks up the ids in its rows, and
    the masked partial rows are summed over the ranks."""
    if not is_dtensor(table):
        return F.embedding(ids, table)
    from torch.distributed.tensor import Replicate, Shard
    mesh = table.device_mesh
    table = table.redistribute(mesh, [pl if pl == Shard(0) else Replicate()
                                      for pl in table.placements])
    out = F.embedding(replicated_like(ids, table), table)
    return out.redistribute(mesh, [Replicate() if pl.is_partial() else pl
                                   for pl in out.placements])


def embed_tokens(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = _lookup(tokens, params["tok"]).to(cfg.cdtype)
    if not cfg.use_rope and positions is not None:
        x = x + _lookup(positions, params["pos"]).to(cfg.cdtype)
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

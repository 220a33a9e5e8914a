"""Shared layers of the port's models (plain functions on tensors).

Port of the parts of ``repro/models/layers.py`` that the Mamba1 path runs:
the parameter initialisers of ``Builder.p`` (``layers.py:37-61``), the norms
(``rmsnorm``, ``layernorm``, ``apply_norm``) and the token embedding and
unembedding.  Attention, RoPE and the MLP come with the dense slice
(ROADMAP §1 item 6).

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

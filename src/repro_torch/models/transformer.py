"""The port's decoder-only LM over stacked layers, for plan kinds ``attn``
(dense, no experts) and ``mamba1``.

Port of ``repro/models/transformer.py``.  Parameters keep the reference's
tree: nested dicts with a leading ``n_layers`` dim on every per-layer leaf,
so a tree made by ``repro.models.transformer.init_params`` and carried
across with ``interop.params_from_numpy`` runs here unchanged.  The
reference's ``lax.scan`` over the stacked layers becomes a Python loop that
indexes the stacked tensors (views, no copies).

This slice serves the dense transformer family (qwen2-7b, qwen3-14b,
granite-20b, yi-9b, llava-next-34b's backbone) and the attention-free
Mamba1 family (falcon-mamba-7b).  MoE, Mamba2, the hybrid and the
encoder-decoder raise ``NotImplementedError`` naming the ROADMAP item that
brings them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..interop import Device, resolve_device
from .config import ModelConfig
from .layers import (apply_norm, attention_block, embed_tokens,
                     init_attention, init_embed, init_mlp, init_norm,
                     init_param, mlp_block, unembed)
from .ssm import init_mamba1, mamba1_block, mamba1_decode_cache


# --------------------------------------------------------------------------
# plan helpers
# --------------------------------------------------------------------------

def _plan_kind(cfg: ModelConfig) -> str:
    kinds = set(cfg.layer_plan)
    if kinds == {"attn"}:
        return "attn"
    if kinds == {"mamba1"}:
        return "mamba1"
    if kinds == {"mamba2"}:
        return "mamba2"
    if kinds <= {"mamba2", "mamba2+shared_attn"}:
        return "mamba2_shared"
    raise ValueError(f"unsupported layer plan {kinds} (scan needs homogeneity)")


def check_supported(cfg: ModelConfig) -> str:
    """The plan kind of ``cfg`` if this port runs it, else raise
    ``NotImplementedError`` naming the ROADMAP item that brings it."""
    kind = _plan_kind(cfg)
    if cfg.is_encoder_decoder:
        what = "encoder-decoder models: ROADMAP §1 item 7"
    elif kind == "mamba1" or (kind == "attn" and not cfg.n_experts):
        return kind
    elif kind == "attn":
        what = "MoE layers: ROADMAP §1 item 7"
    else:
        what = "Mamba2 (SSD) and hybrid layers: ROADMAP §1 item 7"
    raise NotImplementedError(
        f"{cfg.name}: layer plan {kind!r} is not ported yet; it comes with "
        f"{what}")


def param_specs(cfg: ModelConfig) -> Dict:
    """The parameter tree of ``cfg`` with a :class:`ParamSpec` at each leaf:
    the keys, shapes and initialisers of the reference's ``init_params``."""
    kind = check_supported(cfg)
    L = cfg.n_layers
    specs = {
        "embed": init_embed(cfg),
        "final_norm": init_norm("final_norm", cfg),
        "layers": {"norm1": init_norm("layers/norm1", cfg, stacked=L)},
    }
    if kind == "attn":
        specs["layers"]["mixer"] = init_attention("layers/attn", cfg,
                                                  stacked=L)
        specs["layers"]["ffn"] = init_mlp("layers/mlp", cfg, stacked=L)
        specs["layers"]["norm2"] = init_norm("layers/norm2", cfg, stacked=L)
    else:
        specs["layers"]["mixer"] = init_mamba1("layers/mamba1", cfg,
                                               stacked=L)
    return specs


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[Device] = None) -> Dict:
    """Draw the parameters of ``cfg`` on ``device`` (the card unless another
    is named) in ``cfg.pdtype``.

    Each parameter is drawn from its own generator on the device, seeded
    from ``seed`` and the CRC-32 of its name (``layers.param_seed``), with
    the reference's distributions; the values differ from ``jax.random``'s.
    To compute with the reference's numbers, carry its tree across with
    ``interop.params_from_numpy`` instead.
    """
    device = resolve_device(device)
    return _map_tree(lambda s: init_param(s, seed, cfg.pdtype, device),
                     param_specs(cfg))


def count_params(cfg: ModelConfig) -> int:
    return sum(s.numel for s in _leaves(param_specs(cfg)))


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: Optional[Device] = None) -> Dict:
    """Decode cache tree.  ``pos`` is the write cursor (same for the batch).
    An attention cache holds each layer's (batch, max_len, KH, hd) k and v
    in ``dtype`` (the compute type by default), or int8 with bf16 scales
    when ``cfg.kv_cache_dtype == "int8"``; a Mamba1 cache holds each layer's
    conv window and state, so ``max_len`` does not size it."""
    kind = check_supported(cfg)
    device = resolve_device(device)
    dt = dtype or cfg.cdtype
    L = cfg.n_layers
    if kind == "attn":
        shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        if cfg.kv_cache_dtype == "int8":
            layers = {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device)}
        else:
            layers = {"k": torch.zeros(shape, dtype=dt, device=device),
                      "v": torch.zeros(shape, dtype=dt, device=device)}
    else:
        c = mamba1_decode_cache(cfg, batch, dt, device)
        layers = {k: v.expand((L,) + v.shape).contiguous()
                  for k, v in c.items()}
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "layers": layers}


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _layer(tree: Dict, i: int) -> Dict:
    return _map_tree(lambda a: a[i], tree)


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            cache: Optional[Dict] = None,
            patch_embeds: Optional[torch.Tensor] = None,
            impl: str = "kernel"
            ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (logits, new_cache, aux_loss).

    tokens: (B, S) on the parameters' device.  With ``cache``: prefill
    (pos=0, S>1) or decode (S==1, written at ``cache["pos"]``).
    ``patch_embeds`` (B, P, d) overrides the first P embeddings (the VLM
    stub frontend).  Logits are float32.  ``impl`` selects the kernels
    (``"kernel"``: flash attention in prefill, the selective scan) or their
    plain versions (``"ref"``).  The cache given is not changed; a new one
    is returned.  On the attention path, reading the cache's write
    position is the forward's one host sync; a Mamba1 forward needs no
    positions.
    """
    kind = check_supported(cfg)
    B, S = tokens.shape
    pos0 = int(cache["pos"]) if cache is not None and kind == "attn" else 0
    positions = (torch.arange(S, device=tokens.device) + pos0).expand(B, S)
    x = embed_tokens(params["embed"], tokens, cfg, positions)
    if patch_embeds is not None:
        P = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, P:, :]], dim=1)
    lay = params["layers"]
    new_layers = []
    for i in range(cfg.n_layers):
        h = apply_norm(x, _layer(lay["norm1"], i), cfg)
        lcache = _layer(cache["layers"], i) if cache is not None else None
        if kind == "attn":
            h, nc = attention_block(_layer(lay["mixer"], i), h, cfg,
                                    positions=positions, cache=lcache,
                                    cache_pos=pos0, causal=True, impl=impl)
        else:
            h, nc = mamba1_block(_layer(lay["mixer"], i), h, cfg,
                                 cache=lcache, impl=impl)
        x = x + h
        if "ffn" in lay:
            h = apply_norm(x, _layer(lay["norm2"], i), cfg)
            x = x + mlp_block(_layer(lay["ffn"], i), h, cfg)
        new_layers.append(nc)

    x = apply_norm(x, params["final_norm"], cfg)
    logits = unembed(params["embed"], x, cfg)

    new_cache = None
    if cache is not None:
        new_cache = {"pos": cache["pos"] + S,
                     "layers": {k: torch.stack([c[k] for c in new_layers])
                                for k in new_layers[0]}}
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, new_cache, aux


# --------------------------------------------------------------------------
# step builders
# --------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, max_len: Optional[int] = None, *,
                      impl: str = "kernel"):
    """(params, tokens) -> (next_token_logits, cache)."""
    def prefill(params, tokens):
        B, S = tokens.shape
        cache = init_cache(cfg, B, max_len or cfg.max_cache_len or S,
                           device=tokens.device)
        logits, cache, _ = forward(params, tokens, cfg, cache=cache,
                                   impl=impl)
        return logits[:, -1, :], cache
    return prefill


def make_decode_step(cfg: ModelConfig, *, impl: str = "kernel"):
    """(params, cache, token (B,1)) -> (logits (B, V), cache)."""
    def decode(params, cache, token):
        logits, cache, _ = forward(params, token, cfg, cache=cache, impl=impl)
        return logits[:, -1, :], cache
    return decode

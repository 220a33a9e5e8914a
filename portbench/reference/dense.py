"""The dense decoder-only transformer of the configurations whose
``family`` is "dense" (granite-20b as the port runs it): token embedding,
L × (RMSNorm, multi-query or grouped-query causal attention with RoPE,
residual, RMSNorm, a gelu MLP with biases or a SwiGLU one, residual),
RMSNorm, an untied unembedding, float32 throughout.  With ``qkv_bias`` the
q, k and v projections add a bias; with ``qk_norm`` each head's q and k
are RMS-normed (a scale of the head size) before RoPE."""
from __future__ import annotations

from typing import Dict, List

import torch

from ..tree import Leaf, lm_leaves
from .ops import (attention, gelu_tanh, layer_slice, mm, next_token_loss,
                  rmsnorm, rope, silu)


def check(cfg: Dict) -> None:
    if cfg.get("tie_embeddings"):
        raise NotImplementedError("the reference has no tie_embeddings")
    if not cfg.get("use_rope", True) or cfg.get("norm_type", "rmsnorm") \
            != "rmsnorm":
        raise NotImplementedError("the reference has RoPE and RMSNorm only")


def leaves(cfg: Dict) -> List[Leaf]:
    """The common leaves, then each layer's attention and MLP."""
    check(cfg)
    d, L = cfg["d_model"], cfg["n_layers"]
    H, KH, hd, ff = (cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"],
                     cfg["d_ff"])
    out = lm_leaves(cfg) + [
        Leaf("layers/mixer/wq", (L, d, H * hd), "normal"),
        Leaf("layers/mixer/wk", (L, d, KH * hd), "normal"),
        Leaf("layers/mixer/wv", (L, d, KH * hd), "normal"),
        Leaf("layers/mixer/wo", (L, H * hd, d), "normal")]
    if cfg.get("qkv_bias"):
        out += [Leaf("layers/mixer/bq", (L, H * hd), "zeros"),
                Leaf("layers/mixer/bk", (L, KH * hd), "zeros"),
                Leaf("layers/mixer/bv", (L, KH * hd), "zeros")]
    if cfg.get("qk_norm"):
        out += [Leaf("layers/mixer/q_norm", (L, hd), "ones"),
                Leaf("layers/mixer/k_norm", (L, hd), "ones")]
    if cfg["mlp_act"] == "gelu":
        out += [Leaf("layers/ffn/wi", (L, d, ff), "normal"),
                Leaf("layers/ffn/bi", (L, ff), "zeros"),
                Leaf("layers/ffn/wo", (L, ff, d), "normal"),
                Leaf("layers/ffn/bo", (L, d), "zeros")]
    else:
        out += [Leaf("layers/ffn/wi_gate", (L, d, ff), "normal"),
                Leaf("layers/ffn/wi_up", (L, d, ff), "normal"),
                Leaf("layers/ffn/wo", (L, ff, d), "normal")]
    return out + [Leaf("layers/norm2/scale", (L, d), "ones")]


def attention_layers(cfg: Dict) -> int:
    """Every layer attends (``counts/flops.py``)."""
    return cfg["n_layers"]


def _proj(h, mix, w, b, precision):
    out = mm(h, mix[w], precision)
    return out + mix[b] if b in mix else out


def layer(x: torch.Tensor, lp: Dict, cfg: Dict, precision: str
          ) -> torch.Tensor:
    B, S, _ = x.shape
    H, KH, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    mix, ffn = lp["mixer"], lp["ffn"]
    h = rmsnorm(x, lp["norm1"]["scale"], eps)
    q = _proj(h, mix, "wq", "bq", precision).view(B, S, H, hd)
    k = _proj(h, mix, "wk", "bk", precision).view(B, S, KH, hd)
    v = _proj(h, mix, "wv", "bv", precision).view(B, S, KH, hd)
    if "q_norm" in mix:
        q = rmsnorm(q, mix["q_norm"], eps)
        k = rmsnorm(k, mix["k_norm"], eps)
    q, k = rope(q, theta), rope(k, theta)
    o = attention(q.transpose(1, 2).contiguous(),
                  k.transpose(1, 2).contiguous(),
                  v.transpose(1, 2).contiguous(), precision)
    x = x + mm(o.transpose(1, 2).reshape(B, S, H * hd), mix["wo"], precision)
    h = rmsnorm(x, lp["norm2"]["scale"], eps)
    if cfg["mlp_act"] == "gelu":
        h = gelu_tanh(mm(h, ffn["wi"], precision) + ffn["bi"])
        return x + mm(h, ffn["wo"], precision) + ffn["bo"]
    h = silu(mm(h, ffn["wi_gate"], precision)) * mm(h, ffn["wi_up"],
                                                   precision)
    return x + mm(h, ffn["wo"], precision)


def logits_of(params: Dict, x: torch.Tensor, cfg: Dict, precision: str
              ) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"]["scale"], cfg["norm_eps"])
    # the logits stay float32 sums, as the configurations state
    return mm(x, params["embed"]["unembed"], precision, store=False)


def loss(params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
         cfg: Dict, precision: str, run_layer) -> torch.Tensor:
    """The mean next-token loss; ``run_layer(fn, x, i)`` runs layer ``i``
    (the caller checkpoints it)."""
    check(cfg)
    x = params["embed"]["tok"][tokens.long()]
    for i in range(cfg["n_layers"]):
        x = run_layer(lambda x, i=i: layer(
            x, layer_slice(params["layers"], i), cfg, precision), x)
    return next_token_loss(logits_of(params, x, cfg, precision), labels)
